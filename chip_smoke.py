#!/usr/bin/env python3
"""Drive hyperspace_tpu_torch on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py                     # every phase
    python3 chip_smoke.py --phases env,kernels,strings,packed
    python3 chip_smoke.py --phases env,q3
    python3 chip_smoke.py --phases env,refresh
    python3 chip_smoke.py --phases env,q13
    python3 chip_smoke.py --phases env,skipping,delta
    python3 chip_smoke.py --phases env,partitioned
    python3 chip_smoke.py --phases env,setops
    python3 chip_smoke.py --phases env,star
    python3 chip_smoke.py --phases env,resilience
    python3 chip_smoke.py --phases env,analyze
    python3 chip_smoke.py --phases env,history
    python3 chip_smoke.py --phases env,kernels,serve
    python3 chip_smoke.py --phases env,main,dense
    python3 chip_smoke.py --phases env,kernels,surface

Phases, each failing loudly:

1. env       the card's name and power limit, torch and CUDA versions; build
             the CUDA kernels from `hyperspace_tpu_torch/csrc` (timed).
2. kernels   K1 (in-bucket sort), K2 (range probe), K3 (build composite
             sort), K4 (packed-code sort), K5 (packed-code probe) and K6
             (key64) against their plain PyTorch versions at the path's
             shapes and edge cases.
             Outputs are integers: tolerance 0. Times kernel, plain version,
             the library call computing the same function (kernel and library
             as medians of 5 alternating windows), and the bound; splits the
             K1 (at cap 4096), K2, K3, K4 and K5 calls into host and device
             time (`torch.profiler`). K1 also at [1, 32768] on the
             build's composite keys (`partition.composite_build_keys` over
             phase star's item keys), past its tile: the merge passes.
3. main      TPC-H SF1-shaped data made with numpy from --seed (spec clause
             4.2.3 rules), four `create_index` calls, their build stages
             printed (`last_build_stages()`: mode `pipelined-device`, each
             stage's seconds, `overlap_ratio`, `sort_route`, launches);
             ordIdx's files equal to a CPU session's build of the same
             source (the pinned copy ranges at full width), and an ordIdx
             build whose 21st bucket write fails (`storage.write`) raises
             and leaves no index file and no log entry. Then Q3's join (value
             mode: K2), Q9's join (hash mode: K1 + K2) and q3_agg, Q3's
             revenue shape (the Q3 join, a computed revenue column, a group-by
             on o_custkey: sum, count_distinct, count, max). Count and collect
             cold, uncached (every scan cache and join memo emptied before
             each run; p50 of 3) and cached (p50 of 3). Each plan must scan the
             indexes, each kernel must launch, counts and rows must equal a
             numpy join, and q3_agg a numpy group-by (keys and counts exact,
             sums at rtol 1e-9); two uncached q3_agg runs must be bitwise
             equal. Then an uncached and a cached collect are timed stage by
             stage: the scan split into decode, dictionary conversion, copy to
             the device and concatenation; the join's layout into key64, pad
             scatter and K1; q3_agg into scan, join, with_column and aggregate.
4. q3        TPC-H Q3 whole on the same data, with two covering indexes of
             its own (liQ3: lineitem [l_orderkey] with l_extendedprice,
             l_discount, l_shipdate; ordQ3: orders [o_orderkey] with
             o_custkey, o_orderdate, o_shippriority): (lineitem shipped after
             1995-03-15 ⋈ orders placed before it) — the co-bucketed join,
             value mode, K2 — ⋈ BUILDING customers, the general join; then
             revenue, group_by(l_orderkey, o_orderdate, o_shippriority),
             ORDER BY revenue DESC, o_orderdate and LIMIT 10. Runs indexed and
             with Hyperspace disabled (two general joins): cold, uncached p50
             of 3, cached p50 of 3, and an uncached and a cached collect split
             by stage (scans, bucketed join, general join, aggregate, order_by,
             limit). Both must equal a numpy Q3 of the generated arrays (rows
             and order, revenue at rtol 1e-9, tied sort keys as a set) and
             each other.
5. strings   two dictionary-string indexes on the same data: custSeg on
             c_mktsegment (its build sorts with K3) and liShip on l_shipmode
             (its composite overflows int32, so its build must not take K3);
             then Q3's and Q12's predicates through FilterIndexRule with bucket
             pruning, and q12_range (Q12's modes and l_orderkey below its 10th
             percentile, whose row groups the footer zone maps prune), count
             and collect, cold, uncached and cached, against a numpy filter and
             the non-indexed query; q12_range also against its read with
             `HYPERSPACE_SCAN_PUSHDOWN=0`. Prints the row groups each lookup
             decodes of those in its files. Then the join key kinds, indexed
             and in hash mode (K1 then K2): customer ⋈ a copy of it on the
             string c_name, and a copy of o_custkey with 1% nulls (its own
             `RandomState(seed + 1)`) ⋈ customer on c_custkey, each against
             numpy.
6. packed    `pad_buckets_by_codes` (K4) and `probe_code_ranges` (K5), an ops
             API no engine operator calls, on bench.py's packed shape and on
             lineitem's shipmode codes in its l_orderkey bucket layout, against
             the plain probe and numpy searchsorted.
7. refresh   the index lifecycle in a directory of its own: lineitem as 8
             source files of equal row ranges (file 3, a middle range of
             l_orderkey, held back), orders as one; with lineage on, liR (lineitem [l_orderkey] with
             l_extendedprice, l_discount) and ordR (orders [o_orderkey]
             with o_custkey); q_ord's join, count and collect, at each step
             against a numpy join of the files that exist then: (a) fresh,
             value mode (K2); (b) file 3 appended, no refresh: the rule does
             not fire (the general join); (b-h) the same with
             `hyperspace.index.hybridscan.enabled`: the join stays
             co-bucketed over liR and ordR, file 3's rows merged into liR's
             buckets, hash mode (K1, K2), with the merge's split (index
             scan, appended decode, bucketize hash and sort, concatenation
             and dictionary union, interleaving gather), and a
             FilterIndexRule lookup of a key of file 3 whose plan holds the
             Union of the index and the appended file; (b-hd) file 0 moved
             away as well, Hybrid Scan on: lineage prune plus merge, hash
             mode; file 0 moved back and Hybrid Scan off; (c)
             `refresh_index("liR", "incremental")`: two version
             directories, hash mode (K1, K2); (d) file 0 deleted,
             `refresh_index("liR", "auto")`: incremental, no data written,
             `deletedSourceFiles` = [file 0], its rows pruned through the
             lineage column, hash mode; (d-o) `optimize_index("liR")`: one
             file a bucket in one new version directory, no deletes, value
             mode, the compacted files' sha256 set equal to a from-scratch
             `create_index` of the same source in a second warehouse; (e)
             full: one version directory, no deletes, value mode; (f) delete
             (no index), restore (index), a dead refresh's transient entry
             (the stable generation answers), cancel, delete and vacuum (no
             version directory, `indexes()` without liR). Prints each
             refresh's and the compaction's seconds, the join's mode, the
             index files per side and cold, uncached p50 of 3 and cached p50
             of 3 times.
8. q13       TPC-H Q13 whole (without its o_comment LIKE predicate, which
             neither package has) in a directory of its own, over custQ13
             (customer [c_custkey]) and ordQ13 (orders [o_custkey] with
             o_orderkey): customer LEFT OUTER JOIN orders, count(o_orderkey)
             per customer, count(*) per count, ORDER BY custdist DESC,
             c_count DESC. Indexed (the co-bucketed left join, value mode,
             K2) and disabled (the general join, no kernel): cold, uncached
             p50 of 3, cached p50 of 3, a stage split and the outer join's
             split (scans, pairs, the left assembly beside the inner one);
             each equal to numpy's Q13 row for row and to each other, the
             outer join's count to numpy's. Then, indexed, the mirror right
             join, the semi join (Q4's core) and the anti join (Q22's core),
             and a full outer join of o_custkey with 1% nulls (ordNullQ13,
             hash mode: K1 then K2) with customer, each against numpy as a
             multiset, count() equal to the collected rows.
9. skipping  BASELINE config 4 in a directory of its own: TPC-DS SF1's
             store_sales row count (2,880,404) made with numpy from --seed
             as 60 monthly files of 8,192-row row groups (`phase_skipping`
             lists the generator's simplifications); ssSkip, a row-group
             MinMax on ss_sold_date_sk and a 65,536-bit, 5-hash bloom on
             ss_ticket_number. One day and one quarter grouped by store
             (sum of ss_net_paid, count), one ticket, 20 tickets by IN and an
             absent ticket, indexed and disabled, each against numpy with the
             files kept of 60 (the day 1, the quarter 3, the absent ticket
             0, every indexed query below 60); then a 61st month appended
             (no pruning without Hybrid Scan, the 60 sketched files pruned
             with it), an incremental refresh (all 61 pruned) and a month
             deleted with no lineage under Hybrid Scan (still pruned).
             Prints the sketch build and the rule's seconds (cold: the first
             query reads the sketch file; warm) and cold, uncached p50 of 3
             and cached p50 of 3 of each query.
10. delta    BASELINE config 5's source in a directory of its own: lineitem
             as a Delta table of 8 commits (file 3 held back, as phase
             refresh splits it), orders as one file; liD (lineitem
             [l_orderkey] with l_extendedprice, l_discount; lineage on) and
             ordD (orders [o_orderkey] with o_custkey); q_ord's join, count
             and collect at each step against a numpy join of the ACTIVE
             snapshot: (a) fresh, value mode (K2); (b) file 3 committed, no
             refresh: the general join, then Hybrid Scan's hash mode (K1,
             K2); (c) incremental, hash mode; (d) a `remove` commit of file
             0 with its parquet file left on disk, then auto:
             `deletedSourceFiles` = [file 0]; (e) `optimize_index`, its
             sha256 set equal to a from-scratch `create_index` over the same
             snapshot in a second warehouse, value mode; (f) a MinMax
             data-skipping index on l_orderkey: a key range inside file 5
             keeps file 5 only, one inside the removed file 0 keeps none;
             (g) an overwrite commit and a full refresh, value mode. Prints
             each refresh's and the compaction's seconds, the join's mode
             and cold, uncached p50 of 3 and cached p50 of 3 of each step.
11. partitioned  TPC-DS Q3 in a directory of its own: store_sales (TPC-DS
             SF1's 2,880,404 rows, the skipping phase's generator, with
             ss_net_paid standing in for ss_ext_sales_price, which it does
             not make) partitioned by ss_sold_date_sk, one file a day (1,825
             days, 1998-01-02..2002-12-31) and 1% of tickets null-dated
             under __HIVE_DEFAULT_PARTITION__ (this script's share, not
             TPC-DS's rate); item (18,000 rows: i_item_sk 1..18,000,
             i_manufact_id and i_brand_id uniform over 1..1,000, i_brand
             named by its id) as ORC (parquet where pyarrow has no ORC);
             date_dim (73,049 days from d_date_sk 2415022, 1900-01-02, the
             date an ISO string) as CSV; all made with numpy from --seed.
             (a) the read: schema (file columns, then ss_sold_date_sk
             int64), count, a day's rows and is_null; (b) with lineage on,
             ssItem (store_sales [ss_item_sk] with ss_net_paid and the
             partition column, which the join rule must see configured)
             and itemIdx (item [i_item_sk] with i_brand_id, i_brand,
             i_manufact_id), timed, each build's stages printed (ssItem
             over the 1,826 day files); (c) TPC-DS Q3 (d_moy 11, i_manufact_id
             128, by d_year, i_brand, i_brand_id, ORDER BY d_year, the sum
             descending, i_brand_id, LIMIT 100) indexed (store_sales ⋈ item
             co-bucketed: K2, K1 in hash mode; then the general join to
             date_dim on the partition column, where a null date matches
             nothing) and disabled, cold, uncached p50 of 3, cached p50 of 3
             and an uncached run by stage, each in order against numpy (sums
             at rtol 1e-9) and each other; (d) a day (2003-01-01) appended:
             Q3 under Hybrid Scan, after an incremental refresh, and after
             `optimize_index`, whose sha256 set must equal a rebuild's; (e)
             a MinMax sketch on ss_sold_date_sk: a month's group-by keeps 30
             of 1,827 files, indexed and disabled; (f) item again as JSON
             lines under a covering index: a lookup equal to the ORC
             index's and numpy's.
12. setops   TPC-DS Q38 and Q87 at SF1 in a directory of its own
             (`setops_tables`, all made with numpy from --seed): store_sales
             (2,880,404 rows, the skipping phase's generator),
             catalog_sales (1,441,548) and web_sales (719,384) as orders of
             8-16 lines of one date and billed customer, customer (100,000:
             names drawn from 2,000 first and 4,000 last generated names, 1%
             of each null), date_dim with d_month_seq; 1% of the year-2000
             store tickets have their (customer, date) repeated by one
             catalog and one web order (this script's share). ssCust,
             csCust, wsCust (each channel's sales [customer] with the sale
             date) and custIdx (customer [c_customer_sk] with both names)
             make every branch's sales ⋈ customer co-bucketed (K2; K1 in
             hash mode), then a general join to date_dim's year 2000 and the
             distinct (c_last_name, c_first_name, d_date). (a) Q38 (the
             branches intersected) and Q87 (store minus catalog minus web)
             count() indexed and disabled, cold, uncached p50 of 3 and cached
             p50 of 3, an uncached run by stage, the device's busy share and
             the store branch's distinct split (the host's dictionary
             hashing against the whole aggregate);
             (b) Q38's and Q87's rows: numpy's sets, in the store branch's
             order; (c) the branches unioned and deduplicated; (d) Q38 over
             three views, still indexed; (e) `Hyperspace.explain` verbose:
             the four indexes used, ShuffleExchange 12 disabled and 6
             enabled; (f) Q38's plan serialized and back, the same count and
             plan; (g) a UDF (the last name's initial) over Q38's rows,
             grouped, against numpy; (h) `show(20)` and `scalar()`.
13. star     TPC-DS Q3 and Q55 as star joins in a directory of their own
             (`star_tables`, made with numpy from --seed): store_sales
             (2,880,404 rows, the skipping phase's generator, plus
             ss_ext_sales_price = ss_quantity * ss_sales_price as int64
             cents, TPC-DS's decimal(7,2) held exactly; not indexed) as 60
             monthly files, item (18,000 rows as phase partitioned makes
             them, plus i_manager_id over 1..100) and date_dim under
             dateIdx (d_date_sk with d_year, d_moy) and itemIdx (i_item_sk
             with i_brand_id, i_brand, i_manufact_id, i_manager_id);
             itemIdx's build must take the composite sort on K1 (K1
             launched during it) and write a CPU session's build's files. The
             star stream hashes the fact's keys into each dimension's
             buckets, pads and sorts (K1) and probes (K2). (a) Q3, (b) Q55
             and (c) Q55 with a float sum of ss_net_paid (the direct-cells
             path), each four ways: the star stream, `HYPERSPACE_MULTIWAY=0`
             (the cascade), `HYPERSPACE_QUERY_STREAMING=0` and disabled, each
             planning `MultiwayJoinExec` where the JAX package does, each
             against numpy (integers exactly, floats at rtol 1e-9): cold
             count(), uncached and cached collect() p50 of 3, the star's
             stage split (`last_join_stages()`), an uncached run by
             operator (scans against the star stream or the joins), the
             device's busy share, K1 and K2 launches; (d) a streamed scan aggregate over the 60 files
             (count, sums, min, max, avg by store) and its one-pass twin;
             (e) 1,000 items appended as a second item file and a month of
             sales over every item: Q55 under Hybrid Scan.
14. resilience  the planner's model arm and the resilience layer, in a
             directory of its own over the TPC-H tables `tpch()` makes. (a)
             ROADMAP Queue 3's probe at SF1's lineitem row count: 8 parquet
             files of 750,000 rows (`g` an int in 0..99, `p` = rand × 1000,
             18 float64 fillers, from --seed), `group_by("g").agg(s=("p",
             "sum"), c=("*", "count"))` at default flags, cold (footers
             uncached: the default 4,000,000-row chunk, one chunk a file) and
             warm (the planner shapes the chunk to pow2(64 MiB / decoded
             bytes a row) from the footers, so more chunks): the chunk
             counts, the decided chunk_rows, its arithmetic and the
             calibration (the measured host-to-device rate; hash_quantize
             on); both equal numpy (counts exact, sums at rtol 1e-9). (b)
             TPC-H Q3 indexed (liQ3 and ordQ3: value mode, K2) and a
             string-key join (custName ⋈ custName2: hash mode, K1 and K2)
             under `HYPERSPACE_FAULTS=io.decode:0.3:transient` (seed 3,
             12 retries): the clean runs' rows; prints the decode calls,
             injections, retries and K1/K2 launches. (c) one bucket file of
             liQ3 overwritten: the next Q3 warns once and quarantines liQ3,
             its answer (the general join, no kernel) equals numpy; then
             `refresh_index("liQ3", "auto")` lifts the mark and Q3 is
             indexed again (K2) and equal to numpy. (d)
             `HYPERSPACE_QUERY_TIMEOUT_S=0.05` with a 0.2 s hang at every
             decode: `QueryTimeoutError`, and the scan caches' columns and
             tables and the join memos' entries the same before and after;
             then the query without the deadline equals numpy. (e) orders as
             5 files under ordLive (lineage on), file 4 appended: a
             transient fault at `refresh.merge` and then at
             `compact.commit` each fail clean (the stable entry and its
             version directories unchanged, no staging directory), a lookup
             answers, and the retried action succeeds and serves lookups
             through the index.
15. analyze  `explain(analyze=True)` at the main phase's width in a
             directory of its own: TPC-H Q3 over liQ3 and ordQ3 (value mode:
             K2) and TPC-DS Q55 as a star over phase star's tables and
             indexes (hash mode: K1, K2), each uncached under
             `HYPERSPACE_DEVICE_TIMING=all`: rows equal collect() with every
             sink off and numpy, every operator line annotated, the ledger's
             rows_produced the row count, device_time_s in (0, the root's
             wall], and the registry's K1 and K2 counts risen by exactly the
             calls of their C entries (more than 0 over the phase). Then Q55
             under `HYPERSPACE_TRACE_FILE` and `HYPERSPACE_TIMELINE_DIR`: one
             query in the JSONL, each stage its own lane in the Chrome trace.
             Last, cached Q3's p50 of 15 with everything off,
             `HYPERSPACE_TRACING=1`, `HYPERSPACE_ACCOUNTING=1` and
             `HYPERSPACE_DEVICE_TIMING=all`, the four in turns, printed.
16. history  the workload history store, the exporter, the planner's outcome
             store and profile capture, at the main phase's width in a
             directory of its own (Q3 and star Q55 as in analyze): history,
             the exporter's frames, a profile directory and device timing
             on, each query uncached 10 times: every answer equals numpy's
             and the one with everything off, the store holds one baseline
             a class with 10 samples (Q55's with device seconds). Then Q3
             under a 2 s decode hang: one anomaly, on the root span, in a
             frame and in a capture, whose `torch.profiler` window over a
             star Q55 names K1's and K2's kernels. A child process folds the
             same directories alike; the exporter's last frame is final,
             carries live device bytes, and the Prometheus text names K1's
             and K2's launch counters. Prints the planner learning over a
             warm aggregate and cached Q3's p50 with everything off,
             history on and the exporter running, in turns.
17. serve    the serving layer and the replica fleet at the main phase's
             width, in a directory of its own (liQ3, ordQ3, liOrd, ordIdx,
             liPs, psIdx): serial answers of Q3 (K2), Q9's join (K1, K2),
             q3_agg and 48 point lookups (FilterIndexRule, keys from
             --seed) against numpy; then through `hs.server()`, 4 tenants,
             caches emptied before each run: the lookups alone and with 16
             batch collects in a seeded interleaving (4 workers and 1; the
             mix also with the interpreter's switch interval and the
             workers' priority left alone), every answer equal to its
             serial one exactly; lookup p50 / p99 and throughput printed.
             8 identical cold Q3s decode one cold Q3's files. A second
             replica, a child process importing only the port, joins a
             registry (`HYPERSPACE_REPLICAS=1`): both answer Q3 alike, each
             runs the lookups whose file it owns and the two decode counts
             sum to one cold run's, a `refresh_index` here flips the child's
             index cache through the epoch file, the child exits cleanly.
18. identity the join, aggregate, Q3 (general joins, every group), Q13
             (indexed and disabled) and string slices at SF 0.05 with
             device="cpu" and device="cuda": identical index files,
             identical rows in order (sums at rtol 1e-9).
19. mesh     (runs after main and dense) the device mesh at main's width, on
             all cards when two or more are visible, else on a virtual
             4-shard mesh of one card (`parallel.virtual_devices`): (a)
             liOrd, ordIdx, liQ3 and ordQ3 built through the all-to-all
             exchange (default wire: coded and packed lanes; liOrd and
             ordIdx again on the flat wire), each build's part files
             sha256-equal to a single-device build on the card
             (`HYPERSPACE_DISTRIBUTED=0`); (b) q3_agg and Q3 over the
             sharded co-bucketed probe, each probe's K1 and K2 launches
             2 and 1 a shard, Q3's second join and q_ord with Hyperspace
             disabled over the real exchange, each equal to numpy: cold,
             uncached p50 of 3, cached p50 of 3, an uncached run by stage;
             (c) build seconds (mesh, single-device, flat wire), each
             build's and query's `parallel.exchange.*` traffic, the
             probes' and exchanges' seconds, the shards' K1 / K2 shapes,
             and K1 and K2 at one shard's shapes against their plain
             versions, timed beside the library calls and the bound.
20. dense    (runs right after main, on main's indexes; without phase main
             it builds them) the co-bucketed join's dense layout under
             `HYPERSPACE_JOIN_SIZE_CLASSES=0`: every bucket of a side padded
             to the side's largest, one [200, cap] matrix a side. (a) q_ord
             (value mode: K2 only, orders [200, 8192] probing lineitem [200,
             32768]), q_ps (hash mode: K1 on both sides, then K2) and
             q3_agg: cold count and collect, uncached p50 of 3, cached p50 of
             3 beside phase main's classed runs, each equal to numpy and to
             one classed (`=1`) run's answer; the K1 / K2 shapes each cold
             run called and their launches; "join_buckets" pad bytes and
             no "join_class" ones. (b) a skewed pair at main's width:
             lineitem's l_orderkey with 10% of its rows moved to the middle
             order's key (`RandomState(seed + 2)`; the hot bucket's ~627,000
             rows make its cap 1,048,576) under liSkew, joined to orders
             (ordSkew: value mode, K2 [200, 8192] into [200, 1048576]) and to
             orders with 1% of o_orderkey null (ordNullKey,
             `RandomState(seed + 3)`: hash mode, K1 at [200, 1048576] and
             [200, 8192], then K2), each under the classed and the dense
             layouts: cold collect, uncached and cached p50 of 3, both
             layouts' pad bytes, each equal to numpy. Then K1 and K2 at the
             dense shapes of q_ps and of the skewed hash pair against their
             plain versions (max_abs_err over every output, 0), timed
             beside the library calls and the bound; the kernels line
             carries each as `bucket_sort_dense_<pair>_<shape>` or
             `range_probe_dense_<pair>_<shapes>`, with the phase's launches
             at that shape.
21. surface  the JAX package's public surface on the card, at main's width
             in a warehouse of its own: a session on the default device (the
             card) is the active one, `Hyperspace()` takes it, and liOrd and
             ordIdx are built through `IndexConfig.builder()`; main's q_ord
             (value mode: K2) runs uncached once inside `profiling.trace`
             with an `annotate("q_ord")` region, equal to numpy, and the
             Chrome trace must name the region and K2's kernel
             (`windowed_probe`). Then the reference's `examples/quickstart.py`
             and `examples/walkthrough.py`, their imports renamed to the port
             and the JAX platform lines dropped (`port_example_source`),
             each in a child process on the card's default device: each must
             print its own success line. Prints the phase's seconds beside
             the card's `nvidia-smi` line.

Kernel launches are read from the metrics registry
(`kernel.launches.<label>`, which each wrapper's read-only `launches`
reads), set to 0 at the start of each phase that drives the engine (main,
dense, mesh, q3, strings, packed, refresh, q13, skipping, delta, partitioned, setops,
star, resilience, analyze, history, serve, surface) and summed over them. Prints one JSON
line of per-kernel results, the card's `nvidia-smi` line,
and last `{"ok": true, "device": {...}}`. Exits non-zero without a result
when no CUDA device is visible or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (NVIDIA data sheet)
NUM_BUCKETS = 200
PAD = np.iinfo(np.int64).max
DEVICE = "cuda"  # the device every phase drives (the identity phase also runs the CPU)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of `fn()` on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(fn, library, windows: int = 5, iters: int = 10):
    """Median milliseconds a call of `fn` and of `library`, each timed by
    `cuda_ms` (`iters` calls) in `windows` alternating windows, so that
    drift of a shared host falls on both alike."""
    a, b = [], []
    for _ in range(windows):
        a.append(cuda_ms(fn, iters))
        b.append(cuda_ms(library, iters))
    return float(np.median(a)), float(np.median(b))


def host_device_split(torch, fn, iters: int = 10) -> dict:
    """Where one call of `fn` spends its time, over a window of `iters`
    back-to-back calls: the host's enqueue milliseconds a call (host clock, no
    profiler, no sync inside the window), the device's milliseconds a call
    (`torch.profiler` device self time), the host's self microseconds a call
    of each profiled op (its launches are what the profiler names; the rest of
    the host time is Python and the ctypes call), and each device kernel's
    launches and microseconds a call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device_us, ops, kernels = 0.0, {}, {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        device_us += dev_us
        if dev_us > 0:
            kernels[e.key[:60]] = [e.count / iters, dev_us / iters]
        if e.self_cpu_time_total > 0 and e.key != "cudaDeviceSynchronize":
            ops[e.key] = [e.count / iters, e.self_cpu_time_total / iters]
    top = dict(sorted(ops.items(), key=lambda kv: -kv[1][1])[:8])
    return {"host_ms": host_ms, "device_ms": device_us / 1e3 / iters, "host_ops_calls_us": top,
            "device_calls_us": kernels}


def wall(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def sort_case(rng, rows: int, cap: int, kind: str = "hash", fill=(0.0, 1.0)) -> np.ndarray:
    """A padded [rows, cap] int64 key matrix as the join builds it: a valid
    prefix per row (a `fill` fraction of cap), int64-max pads after it."""
    if kind == "dup":
        keys = np.full((rows, cap), 7, np.int64)
    elif kind == "extreme":
        keys = rng.choice(
            np.array([-(2**63), -(2**63) + 1, -1, 0, 1, 2**63 - 2], np.int64), size=(rows, cap)
        )
    else:
        keys = rng.randint(-(2**62), 2**62, size=(rows, cap), dtype=np.int64)
    lens = rng.randint(int(fill[0] * cap), int(fill[1] * cap) + 1, size=rows)
    if kind == "allpad":
        lens[:] = 0
    for b in range(rows):
        keys[b, lens[b]:] = PAD
    return keys


def probe_case(rng, rows: int, cap_l: int, cap_r: int, dtype=np.int64, distinct: int = 0,
               fill=(0.0, 1.0)):
    """Sorted padded left/right matrices and valid lengths (a `fill` fraction
    of each cap); keys drawn from `distinct` values so duplicate runs occur."""
    hi = distinct or 4 * cap_r
    l_len = rng.randint(int(fill[0] * cap_l), int(fill[1] * cap_l) + 1, size=rows)
    r_len = rng.randint(int(fill[0] * cap_r), int(fill[1] * cap_r) + 1, size=rows)
    ls = np.full((rows, cap_l), PAD, np.int64)
    rs = np.full((rows, cap_r), PAD, np.int64)
    for b in range(rows):
        ls[b, : l_len[b]] = np.sort(rng.randint(0, hi, l_len[b]))
        rs[b, : r_len[b]] = np.sort(rng.randint(0, hi, r_len[b]))
    if dtype == np.float64:
        ls = np.where(ls == PAD, np.finfo(np.float64).max, (ls - hi / 2) / 7.0)
        rs = np.where(rs == PAD, np.finfo(np.float64).max, (rs - hi / 2) / 7.0)
    return ls, rs, l_len.astype(np.int64), r_len.astype(np.int64)


def probe_window_cases(rng):
    """K2's windowed probe at the cases its design must keep exact: unsorted
    left rows (a tile's window spans the row, wider than the stage), a hot key
    whose right run is wider than the stage, tiles that are all pad, windows
    at the row's start and end, float64 keys of both signs, cap_l > cap_r, and
    caps that take the scalar loads (odd, or not a multiple of a thread's
    keys). Yields (ls, rs, l_len, r_len)."""
    for rows, cap_l, cap_r, dtype in [(4, 8192, 32768, np.int64), (3, 4096, 32768, np.float64),
                                      (3, 1024, 4096, np.int64)]:
        ls, rs, l_len, r_len = probe_case(rng, rows, cap_l, cap_r, dtype, fill=(0.5, 1.0))
        for b in range(rows):
            rng.shuffle(ls[b, : l_len[b]])
        yield ls, rs, l_len, r_len
    hot_l, hot_r = np.full((2, 1024), 7, np.int64), np.full((2, 65536), 7, np.int64)
    yield hot_l, hot_r, np.array([1024, 700]), np.array([65536, 40000])
    ls, rs, l_len, r_len = probe_case(rng, 5, 8192, 32768, fill=(0.88, 0.96))
    l_len[:] = [0, 1, 2047, 2048, 2049]
    yield ls, rs, l_len, r_len
    for dtype in (np.int64, np.float64):
        ls, rs, l_len, r_len = probe_case(rng, 3, 8192, 32768, dtype, fill=(0.88, 0.96))
        lo_key, hi_key = (-1e300, 1e300) if dtype == np.float64 else (-(2**62), 2**62)
        ls[:, 0], ls[0, 1] = lo_key, lo_key  # below every right key
        for b in range(3):
            ls[b, l_len[b] - 1] = hi_key  # above every right key
        ls[2, : l_len[2]] = np.sort(np.where(np.arange(l_len[2]) % 2 == 0, lo_key, hi_key))
        yield ls, rs, l_len, r_len
    yield probe_case(rng, 3, 8192, 32768, np.float64, fill=(0.88, 0.96))
    for rows, cap_l, cap_r, distinct in [(3, 32768, 4096, 0), (4, 8192, 1024, 500), (3, 1000, 3001, 0),
                                         (3, 3001, 1000, 0), (2, 8191, 32767, 0)]:
        yield probe_case(rng, rows, cap_l, cap_r, distinct=distinct)


def check_sort(torch, cuda_sort, keys_np) -> int:
    keys = torch.from_numpy(keys_np).cuda()
    got_k, got_o = cuda_sort.sort_rows(keys)
    ref_k, ref_o = cuda_sort.sort_rows_plain(keys)
    torch.cuda.synchronize()
    if not (torch.equal(got_k, ref_k) and torch.equal(got_o, ref_o)):
        raise AssertionError(f"K1 disagrees with its plain version at {keys_np.shape}")
    return 0


def check_probe(torch, cuda_probe, ls_np, rs_np, l_len_np, r_len_np) -> int:
    args = [torch.from_numpy(a).cuda() for a in (ls_np, rs_np, l_len_np, r_len_np)]
    got_lo, got_c = cuda_probe.range_probe(*args)
    ref_lo, ref_c = cuda_probe.range_probe_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got_lo, ref_lo) and torch.equal(got_c, ref_c)):
        raise AssertionError(f"K2 disagrees with its plain version at {ls_np.shape} x {rs_np.shape}")
    return 0


def phase_kernels(torch, rng):
    from hyperspace_tpu_torch.ops import cuda_probe, cuda_sort

    # Edge cases first: exact equality, no timing. K1's merge sort holds 8
    # pairs a thread (caps 8 and 16 are one and two threads' worth), sorts
    # tiles of 4096 or 8192 pairs in one launch and adds a merge pass over
    # device memory per doubling above that (131072: four passes).
    for rows, cap, kind in [
        (3, 1, "hash"), (5, 2, "hash"), (9, 8, "hash"), (3, 16, "hash"), (5, 32, "dup"), (7, 256, "hash"),
        (6, 1024, "dup"), (6, 1024, "allpad"), (5, 4096, "hash"), (6, 4096, "extreme"), (3, 4096, "allpad"),
        (4, 8192, "hash"), (4, 8192, "extreme"), (4, 16384, "hash"), (4, 32768, "hash"), (3, 32768, "dup"),
        (3, 65536, "hash"), (2, 65536, "extreme"), (2, 131072, "hash"), (2, 131072, "dup"),
    ]:
        check_sort(torch, cuda_sort, sort_case(rng, rows, cap, kind))
    for rows, cap_l, cap_r, dtype, distinct in [
        (5, 1, 1, np.int64, 0), (5, 2, 256, np.int64, 0), (7, 256, 256, np.int64, 3),
        (6, 4096, 4096, np.int64, 0), (6, 1024, 8192, np.int64, 50), (6, 512, 512, np.float64, 40),
        (4, 2048, 32768, np.float64, 0),
    ]:
        check_probe(torch, cuda_probe, *probe_case(rng, rows, cap_l, cap_r, dtype, distinct))
    ls, rs, l_len, r_len = probe_case(rng, 4, 64, 64)
    r_len[0] = 0
    l_len[1] = 0
    check_probe(torch, cuda_probe, ls, rs, l_len, r_len)
    # Lengths outside [0, cap] clamp, in the kernel as in the plain version.
    l_len[2], r_len[2], l_len[3], r_len[3] = 64 + 9, 64 + 3, -2, -7
    check_probe(torch, cuda_probe, ls, rs, l_len, r_len)
    ext = np.array([[-(2**63), -5, 0, 2**63 - 2]], np.int64)
    check_probe(torch, cuda_probe, ext, ext.copy(), np.array([4]), np.array([4]))
    for case in probe_window_cases(rng):
        check_probe(torch, cuda_probe, *case)
    log("[kernels] edge cases: K1 and K2 equal their plain versions exactly")

    shapes = []
    # K1 at the slice's shapes: lineitem buckets (cap 32768) and partsupp (4096).
    # Buckets fill 88-96% of their pow2 cap at SF1 (lineitem ~30K of 32768).
    main_fill = (0.88, 0.96)
    for rows, cap in [(256, 32768), (256, 4096)]:
        keys_np = sort_case(rng, rows, cap, fill=main_fill)
        check_sort(torch, cuda_sort, keys_np)
        keys = torch.from_numpy(keys_np).cuda()
        n = rows * cap
        b_ms, b_by = bound(n * (8 + 8 + 4), rows * cap * np.log2(max(cap, 2)))
        kernel = lambda: cuda_sort.sort_rows(keys)  # noqa: E731
        library = lambda: torch.sort(keys, dim=1, stable=True)  # noqa: E731
        ms, library_ms = paired_ms(kernel, library)
        shape = {
            "kernel": "K1", "shape": [rows, cap], "ms": ms, "library_ms": library_ms,
            "plain_ms": cuda_ms(lambda: cuda_sort.sort_rows_plain(keys)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0,
        }
        if cap == 4096:  # where the host's cost per call may decide the time
            shape["split"] = host_device_split(torch, kernel)
            shape["library_split"] = host_device_split(torch, library)
        shapes.append(shape)
    # K1 at the build's composite sort: phase star's itemIdx, 18,000
    # item keys (1..18,000 in file order) and their bucket ids packed as
    # `composite_build_sort` packs them, padded to [1, 32768]: past the
    # 8192-pair tile, so two merge passes through the scratch buffer.
    from hyperspace_tpu_torch.ops.hashing import bucket_id
    from hyperspace_tpu_torch.ops.partition import composite_build_keys

    item_sk = torch.arange(1, ITEM_ROWS + 1, dtype=torch.int64, device="cuda")
    comp, _ = composite_build_keys(bucket_id([item_sk], NUM_BUCKETS), item_sk, ITEM_ROWS, NUM_BUCKETS)
    check_sort(torch, cuda_sort, comp.cpu().numpy())
    n = comp.numel()
    b_ms, b_by = bound(n * (8 + 8 + 4), n * np.log2(n))
    ms, library_ms = paired_ms(lambda: cuda_sort.sort_rows(comp), lambda: torch.sort(comp, dim=1, stable=True))
    shapes.append({
        "kernel": "K1", "shape": list(comp.shape), "role": "composite build sort", "ms": ms,
        "library_ms": library_ms, "plain_ms": cuda_ms(lambda: cuda_sort.sort_rows_plain(comp)),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0,
    })
    # K2: orders (8192) into lineitem (32768), partsupp (4096) into lineitem.
    for rows, cap_l, cap_r in [(256, 8192, 32768), (256, 4096, 32768)]:
        ls_np, rs_np, l_len_np, r_len_np = probe_case(rng, rows, cap_l, cap_r, fill=main_fill)
        check_probe(torch, cuda_probe, ls_np, rs_np, l_len_np, r_len_np)
        ls, rs, l_len, r_len = (torch.from_numpy(a).cuda() for a in (ls_np, rs_np, l_len_np, r_len_np))
        n_l, n_r = int(l_len_np.sum()), int(r_len_np.sum())
        nbytes = 8 * n_l + 8 * n_r + 8 * rows + 8 * rows * cap_l
        ops = 2 * n_l * np.log2(max(int(r_len_np.max()), 2))
        b_ms, b_by = bound(nbytes, ops)
        kernel = lambda: cuda_probe.range_probe(ls, rs, l_len, r_len)  # noqa: E731
        ms, library_ms = paired_ms(kernel,
                                   lambda: (torch.searchsorted(rs, ls), torch.searchsorted(rs, ls, right=True)))
        shapes.append({
            "kernel": "K2", "shape": [[rows, cap_l], [rows, cap_r]], "ms": ms, "library_ms": library_ms,
            "plain_ms": cuda_ms(lambda: cuda_probe.range_probe_plain(ls, rs, l_len, r_len), iters=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0, "split": host_device_split(torch, kernel),
        })
    shapes += phase_packed_kernels(torch, rng)
    shapes += phase_hash_kernel(torch, rng)
    for s in shapes:
        log(f"[kernels] {json.dumps(s)}")
    return shapes


def comp_case(torch, rng, rows: int, n: int, n_pad: int, card: int = 5, num_buckets: int = NUM_BUCKETS):
    """Build composites as `packed_build_sort` packs them: random bucket ids
    and codes (-1 = null lane) for the first n slots of each row, the pad
    composite after them."""
    from hyperspace_tpu_torch.engine.packed_codes import bits_for_cardinality
    from hyperspace_tpu_torch.ops.partition import packed_build_comp

    bits = bits_for_cardinality(card)
    log2np = n_pad.bit_length() - 1
    out = []
    for _ in range(rows):
        b = torch.from_numpy(rng.randint(0, num_buckets, n).astype(np.int32))
        codes = torch.from_numpy(rng.randint(-1, card, n).astype(np.int32))
        out.append(packed_build_comp(b, codes, bits, log2np, n_pad, num_buckets))
    return torch.cat(out).contiguous()


def lanes_case(rng, rows: int, cap: int, bits: int, fill=(0.0, 1.0), sort_rows_too: bool = False,
               kind: str = "random"):
    """Biased code lanes [rows, cap] with a valid prefix per row (a `fill`
    fraction of cap, real lanes below the top value) and pads at the top lane
    value 2**bits - 1; rows sorted when asked. "one": one lane value fills
    each row; "every": each row starts with every lane value, the top one
    too. Returns (lanes, lengths)."""
    top = (1 << bits) - 1
    lanes = rng.randint(0, top, size=(rows, cap)).astype(np.int32)
    if kind == "one":
        lanes[:] = rng.randint(0, top + 1, size=(rows, 1))
    lens = rng.randint(int(fill[0] * cap), int(fill[1] * cap) + 1, size=rows)
    for b in range(rows):
        if kind == "every" and cap > top:
            lanes[b, : top + 1] = np.arange(top + 1)
        if sort_rows_too:
            lanes[b, : lens[b]] = np.sort(lanes[b, : lens[b]])
        lanes[b, lens[b]:] = top
    return lanes, lens.astype(np.int64)


INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def comp_values_case(rng, rows: int, cap: int, kind: str) -> np.ndarray:
    """[rows, cap] int32 keys of any sign, beyond the build's composites:
    "wide" uniform over int32, "dup" a handful of values around 0, "extreme"
    the int32 ends and their neighbours, "allpad" one value everywhere."""
    if kind == "wide":
        v = rng.randint(INT32_MIN, INT32_MAX + 1, size=(rows, cap), dtype=np.int64)
    elif kind == "dup":
        v = rng.randint(-3, 4, size=(rows, cap))
    elif kind == "extreme":
        v = rng.choice(np.array([INT32_MIN, INT32_MIN + 1, -1, 0, 1, INT32_MAX - 1, INT32_MAX]), size=(rows, cap))
    else:
        v = np.full((rows, cap), INT32_MAX)
    return v.astype(np.int32)


def probe_lanes_case(rng, rows: int, cap_l: int, cap_r: int, bits: int, kind: str):
    """Sorted left and right lane rows whose values stress the lane table:
    "single" one lane value per right row, "absent" left lanes that the right
    row never holds, "every" rows holding every lane value (the top one too),
    "dups" two values. Pads at the top lane value. Returns (L, R, l_len, r_len)."""
    top = (1 << bits) - 1
    l_len = rng.randint(0, cap_l + 1, rows)
    r_len = rng.randint(0, cap_r + 1, rows)
    L = np.full((rows, cap_l), top, np.int64)
    R = np.full((rows, cap_r), top, np.int64)
    for b in range(rows):
        n, m = l_len[b], r_len[b]
        if kind == "single":
            R[b, :m] = rng.randint(0, top + 1)
            L[b, :n] = rng.randint(0, top + 1, n)
        elif kind == "absent":
            R[b, :m] = 2 * rng.randint(0, (top + 1) // 2, m)
            L[b, :n] = 2 * rng.randint(0, (top + 1) // 2, n) + 1
        elif kind == "every":
            if m > top:
                R[b, :m] = np.concatenate([np.arange(top + 1), rng.randint(0, top + 1, m - top - 1)])
            L[b, :n] = rng.randint(0, top + 1, n)
        else:
            pair = rng.choice(top + 1, 2, replace=False)
            R[b, :m] = rng.choice(pair, m)
            L[b, :n] = rng.choice(pair, n)
        L[b, :n].sort()
        R[b, :m].sort()
    return L, R, l_len.astype(np.int64), r_len.astype(np.int64)


def check_comp(torch, cuda_comp_sort, v) -> None:
    got = cuda_comp_sort.sort_comp_rows(v)
    want = cuda_comp_sort.sort_comp_rows_plain(v)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K3 disagrees with its plain version at {tuple(v.shape)}")


def check_packed_sort(torch, cuda_packed_sort, words, bits) -> None:
    got = cuda_packed_sort.sort_codes_packed(words, bits)
    want = cuda_packed_sort.sort_codes_packed_plain(words, bits)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"K4 disagrees with its plain version at {tuple(words.shape)}, bits {bits}")


def check_packed_probe(torch, cuda_packed_probe, lw, rw, bits, l_len, r_len) -> None:
    got = cuda_packed_probe.probe_packed(lw, rw, bits, l_len, r_len)
    want = cuda_packed_probe.probe_packed_plain(lw, rw, bits, l_len, r_len)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"K5 disagrees with its plain version at {tuple(lw.shape)} x {tuple(rw.shape)}, bits {bits}")


def phase_packed_kernels(torch, rng):
    """K3, K4 and K5 against their plain versions (tolerance 0), then timed."""
    from hyperspace_tpu_torch.engine.packed_codes import pack_rows, unpack_rows
    from hyperspace_tpu_torch.ops import cuda_comp_sort, cuda_packed_probe, cuda_packed_sort

    dev = torch.device("cuda")
    # K3 edge cases: build composites with one slot, pads only, several rows,
    # rows within one radix tile (2048 keys) and across many; then keys of any
    # sign, duplicates, the int32 ends and all-pad rows, below, at and above
    # the tile, rows of the wide tile (4096 keys, from 2^21 keys a matrix) and
    # one row of 2^23 keys.
    for rows, n, n_pad in [(1, 1, 2), (1, 2, 2), (1, 0, 4), (3, 1000, 1024), (2, 32768, 32768),
                           (2, 40000, 65536), (1, 262144, 262144)]:
        check_comp(torch, cuda_comp_sort, comp_case(torch, rng, rows, n, n_pad).to(dev))
    for rows, cap, kind in [(4, 65536, "wide"), (4, 65536, "dup"), (3, 1024, "wide"), (3, 2048, "extreme"),
                            (2, 4096, "dup"), (5, 1, "wide"), (2, 2, "extreme"), (4, 8192, "allpad"),
                            (6, 32, "extreme"), (2, 1 << 20, "dup"), (1, 1 << 23, "wide")]:
        check_comp(torch, cuda_comp_sort, torch.from_numpy(comp_values_case(rng, rows, cap, kind)).to(dev))
    # K4 and K5 edge cases at every width: a row of one word, empty and
    # all-pad rows, rows that cross tiles.
    for bits in (1, 2, 4):
        lpw = 32 // bits
        for rows, cap, fill in [(3, lpw, (0.0, 1.0)), (8, 256, (0.0, 0.0)), (8, 256, (1.0, 1.0)),
                                (5, 4096, (0.0, 1.0)), (2, 65536, (0.5, 1.0))]:
            lanes, lens = lanes_case(rng, rows, cap, bits, fill)
            words = pack_rows(torch.from_numpy(lanes), bits).to(dev)
            check_packed_sort(torch, cuda_packed_sort, words, bits)
            for cap_r in (cap, 4 * cap if cap < 65536 else cap):
                l_lanes, l_lens = lanes_case(rng, rows, cap, bits, fill, sort_rows_too=True)
                r_lanes, r_lens = lanes_case(rng, rows, cap_r, bits, fill, sort_rows_too=True)
                r_lens[0] = 0
                if rows > 2:  # lengths outside [0, cap] clamp
                    l_lens[1], r_lens[1], l_lens[2], r_lens[2] = cap + 5, cap_r + 9, -1, -3
                lw = pack_rows(torch.from_numpy(l_lanes), bits).to(dev)
                rw = pack_rows(torch.from_numpy(r_lanes), bits).to(dev)
                check_packed_probe(torch, cuda_packed_probe, lw, rw, bits,
                                   torch.from_numpy(l_lens).to(dev), torch.from_numpy(r_lens).to(dev))
        # The lane table's cases, with int64 and int32 lengths; rows of 32768
        # left lanes span 4 blocks of 8192.
        for kind in ("single", "absent", "every", "dups"):
            for rows, cap_l, cap_r in [(6, 256, 1024), (3, 32768, 4096)]:
                L, R, l_lens, r_lens = probe_lanes_case(rng, rows, cap_l, cap_r, bits, kind)
                lw = pack_rows(torch.from_numpy(L), bits).to(dev)
                rw = pack_rows(torch.from_numpy(R), bits).to(dev)
                for dtype in (torch.int64, torch.int32):
                    check_packed_probe(torch, cuda_packed_probe, lw, rw, bits,
                                       torch.from_numpy(l_lens).to(dev, dtype), torch.from_numpy(r_lens).to(dev, dtype))
    # K4's counting sort: rows of one lane value, rows holding every value,
    # and rows longer than the 32768 slots it stages in shared memory.
    for bits, rows, cap in [(4, 3, 8), (2, 3, 16), (1, 3, 32), (4, 6, 4096), (2, 6, 4096), (1, 6, 4096),
                            (4, 3, 65536), (4, 2, 131072), (1, 2, 1 << 20)]:
        for kind in ("random", "one", "every"):
            lanes, _ = lanes_case(rng, rows, cap, bits, kind=kind)
            check_packed_sort(torch, cuda_packed_sort, pack_rows(torch.from_numpy(lanes), bits).to(dev), bits)
    log("[kernels] edge cases: K3, K4 and K5 equal their plain versions exactly")

    shapes = []
    # K3 at the custSeg build (150,000 customers, 200 buckets -> [1, 262144])
    # and a larger build row ([1, 2^22]; 16 buckets keep its composite within
    # int32).
    for n, n_pad, nb in [(150_000, 262_144, NUM_BUCKETS), (3_000_000, 4_194_304, 16)]:
        v = comp_case(torch, rng, 1, n, n_pad, num_buckets=nb).to(dev)
        check_comp(torch, cuda_comp_sort, v)
        b_ms, b_by = bound(8 * n_pad, n_pad * np.log2(n_pad))
        kernel = lambda: cuda_comp_sort.sort_comp_rows(v)  # noqa: E731
        ms, library_ms = paired_ms(kernel, lambda: torch.sort(v, dim=1))
        shape = {
            "kernel": "K3", "shape": [1, n_pad], "ms": ms, "library_ms": library_ms,
            "plain_ms": cuda_ms(lambda: cuda_comp_sort.sort_comp_rows_plain(v)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0,
        }
        shape["split"] = host_device_split(torch, kernel)
        shapes.append(shape)
    # K4 and K5 at bench.py's packed shape (64 buckets, ~1900 rows each: cap
    # 4096 at ~45% fill is its class) and at lineitem's shipmode buckets
    # (200 buckets of ~30,000 rows, cap 32768), bits 4; bits 1 and 2 at 4096.
    for rows, cap, bits, fill in [(200, 32768, 4, (0.88, 0.96)), (64, 4096, 4, (0.4, 0.55)),
                                  (64, 4096, 2, (0.4, 0.55)), (64, 4096, 1, (0.4, 0.55))]:
        lanes, lens = lanes_case(rng, rows, cap, bits, fill)
        words = pack_rows(torch.from_numpy(lanes), bits).to(dev)
        check_packed_sort(torch, cuda_packed_sort, words, bits)
        flat = torch.from_numpy(lanes).to(dev)
        b_ms, b_by = bound(rows * cap * (bits / 8 + 8), rows * cap * np.log2(cap))
        kernel = lambda: cuda_packed_sort.sort_codes_packed(words, bits)  # noqa: E731
        library = lambda: torch.sort(flat, dim=1, stable=True)  # noqa: E731
        ms, library_ms = paired_ms(kernel, library)
        shape = {
            "kernel": "K4", "shape": [rows, cap], "bits": bits, "ms": ms, "library_ms": library_ms,
            "plain_ms": cuda_ms(lambda: cuda_packed_sort.sort_codes_packed_plain(words, bits)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0,
        }
        shape["split"] = host_device_split(torch, kernel)
        if cap == 4096:
            shape["library_split"] = host_device_split(torch, library)
        shapes.append(shape)
        l_lanes, l_lens = lanes_case(rng, rows, cap, bits, fill, sort_rows_too=True)
        r_lanes, r_lens = lanes_case(rng, rows, cap, bits, fill, sort_rows_too=True)
        lw = pack_rows(torch.from_numpy(l_lanes), bits).to(dev)
        rw = pack_rows(torch.from_numpy(r_lanes), bits).to(dev)
        l_len, r_len = torch.from_numpy(l_lens).to(dev), torch.from_numpy(r_lens).to(dev)
        check_packed_probe(torch, cuda_packed_probe, lw, rw, bits, l_len, r_len)
        lf, rf = unpack_rows(lw, bits), unpack_rows(rw, bits)
        n_l = int(l_lens.sum())
        nbytes = 2 * rows * cap * bits / 8 + 8 * rows + 8 * rows * cap
        ops = 2 * n_l * np.log2(max(int(r_lens.max()), 2))
        b_ms, b_by = bound(nbytes, ops)
        kernel = lambda: cuda_packed_probe.probe_packed(lw, rw, bits, l_len, r_len)  # noqa: E731
        library = lambda: (torch.searchsorted(rf, lf), torch.searchsorted(rf, lf, right=True))  # noqa: E731
        ms, library_ms = paired_ms(kernel, library)
        shape = {
            "kernel": "K5", "shape": [rows, cap], "bits": bits, "ms": ms, "library_ms": library_ms,
            "plain_ms": cuda_ms(lambda: cuda_packed_probe.probe_packed_plain(lw, rw, bits, l_len, r_len),
                                iters=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0,
        }
        shape["split"] = host_device_split(torch, kernel)
        if cap == 4096:  # where the host's cost per call decides the time
            shape["library_split"] = host_device_split(torch, library)
        shapes.append(shape)
    return shapes


# K6's shapes in the benchmark's cell `tpch_sf10.q3_streams3` (lakebench): the
# rows of one Q3 query's aggregate (its three group keys) and of the general
# join's side from the co-bucketed join (`o_custkey`), read from
# `explain(analyze=True)` of Q3 at SF10 (DATE 1995-03-18, SEGMENT BUILDING).
K6_AGG_ROWS = 300_413
K6_JOIN_ROWS = 1_499_335


def phase_hash_kernel(torch, rng):
    """K6 against the plain chain (tolerance 0), then timed at Q3's two
    key64 shapes: kernel and plain version as medians of 5 alternating
    windows of 10 calls, the bound the lanes' bytes read and 8 bytes a row
    written, and each one's host and device time a call. No single PyTorch
    call computes key64, so there is no library time."""
    from hyperspace_tpu_torch.ops import cuda_hash
    from hyperspace_tpu_torch.ops.hashing import key64, key64_plain

    dev = torch.device("cuda")
    n_agg, n_join = K6_AGG_ROWS, K6_JOIN_ROWS
    orderkey = torch.from_numpy(rng.randint(1, 60_000_001, n_agg).astype(np.int64)).to(dev)
    orderdate = torch.from_numpy(rng.randint(8766, 8826, n_agg).astype(np.int32)).to(dev)
    shippriority = torch.zeros(n_agg, dtype=torch.int32, device=dev)
    custkey = torch.from_numpy(rng.randint(1, 1_500_001, n_join).astype(np.int64)).to(dev)
    shapes = []
    for role, lanes in (("aggregate keys", [orderkey, orderdate, shippriority]), ("general join key", [custkey])):
        if not torch.equal(key64(lanes), key64_plain(lanes)):
            raise AssertionError(f"K6 disagrees with its plain version ({role})")
        before = cuda_hash.launches
        key64(lanes)
        torch.cuda.synchronize()
        launches = cuda_hash.launches - before
        n = int(lanes[0].shape[0])
        b_ms, b_by = bound(n * (sum(x.element_size() for x in lanes) + 8), 0)
        kernel = lambda: key64(lanes)  # noqa: E731
        plain = lambda: key64_plain(lanes)  # noqa: E731
        ms, plain_ms = paired_ms(kernel, plain)
        shapes.append({
            "kernel": "K6", "role": role, "shape": [n, len(lanes)], "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "launches_a_call": launches,
            "max_abs_err": 0, "split": host_device_split(torch, kernel), "plain_split": host_device_split(torch, plain),
        })
    return shapes


# ---------------------------------------------------------------------------
# TPC-H-shaped data (spec clause 4.2.3)
# ---------------------------------------------------------------------------


# Clause 4.2.2.13 lists, sorted: dictionary order is value order.
SEGMENTS = np.array(sorted(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]))
SHIPMODES = np.array(sorted(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]))


def days(date: str) -> int:
    """A date as int32 days since 1970-01-01, the port's date columns."""
    return int(np.datetime64(date, "D").astype(np.int64))


START_DATE, END_DATE = days("1992-01-01"), days("1998-12-31")  # clause 4.2.3
Q3_DATE = days("1995-03-15")


def tpch(sf: float, seed: int):
    rng = np.random.RandomState(seed)
    n_orders = int(1_500_000 * sf)
    n_cust = int(150_000 * sf)
    n_part = int(200_000 * sf)
    n_supp = int(10_000 * sf)
    i = np.arange(n_orders, dtype=np.int64)
    o_orderkey = (i // 8) * 32 + (i % 8) + 1  # sparse keys: 8 of every 32
    k = rng.randint(0, (2 * n_cust) // 3, n_orders).astype(np.int64)
    o_custkey = 3 * (k // 2) + (k % 2) + 1  # every third customer has no orders
    lines = rng.randint(1, 8, n_orders)
    n_lines = int(lines.sum())
    l_orderkey = np.repeat(o_orderkey, lines)
    first = np.cumsum(lines) - lines
    l_linenumber = (np.arange(n_lines) - np.repeat(first, lines) + 1).astype(np.int64)
    l_partkey = rng.randint(1, n_part + 1, n_lines).astype(np.int64)
    supp_i = rng.randint(0, 4, n_lines).astype(np.int64)

    def suppkey(p, j):
        return (p + j * (n_supp // 4 + (p - 1) // n_supp)) % n_supp + 1

    l_suppkey = suppkey(l_partkey, supp_i)
    l_quantity = rng.randint(1, 51, n_lines).astype(np.float64)
    retail = (90000 + (l_partkey // 10) % 20001 + 100 * (l_partkey % 1000)) / 100.0
    l_extendedprice = np.round(l_quantity * retail, 2)
    l_discount = rng.randint(0, 11, n_lines) / 100.0
    l_tax = rng.randint(0, 9, n_lines) / 100.0
    charge = l_extendedprice * (1 + l_tax) * (1 - l_discount)
    o_totalprice = np.round(np.add.reduceat(charge, first), 2)
    ps_partkey = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    ps_suppkey = suppkey(ps_partkey, np.tile(np.arange(4, dtype=np.int64), n_part))
    ps_availqty = rng.randint(1, 10000, 4 * n_part).astype(np.int64)
    ps_supplycost = rng.randint(100, 100001, 4 * n_part) / 100.0
    # String columns (clause 4.2.3), drawn after the numeric ones so those stay
    # as they were; held as (sorted dictionary, codes).
    c_custkey = np.arange(1, n_cust + 1, dtype=np.int64)
    c_name = (np.array([f"Customer#{k:09d}" for k in c_custkey]), np.arange(n_cust, dtype=np.int32))
    c_mktsegment = (SEGMENTS, rng.randint(0, len(SEGMENTS), n_cust).astype(np.int32))
    c_acctbal = rng.randint(-99999, 1000000, n_cust) / 100.0
    l_shipmode = (SHIPMODES, rng.randint(0, len(SHIPMODES), n_lines).astype(np.int32))
    # Q3's dates (clause 4.2.3), drawn after everything above so that it stays
    # byte-identical: int32 days since 1970-01-01.
    o_orderdate = rng.randint(START_DATE, END_DATE - 151 + 1, n_orders).astype(np.int32)
    o_shippriority = np.zeros(n_orders, dtype=np.int32)
    l_shipdate = (np.repeat(o_orderdate, lines) + rng.randint(1, 122, n_lines)).astype(np.int32)
    return {
        "lineitem": {
            "l_orderkey": l_orderkey, "l_partkey": l_partkey, "l_suppkey": l_suppkey,
            "l_linenumber": l_linenumber, "l_quantity": l_quantity,
            "l_extendedprice": l_extendedprice, "l_discount": l_discount, "l_tax": l_tax,
            "l_shipmode": l_shipmode, "l_shipdate": l_shipdate,
        },
        "customer": {
            "c_custkey": c_custkey, "c_name": c_name, "c_mktsegment": c_mktsegment, "c_acctbal": c_acctbal,
        },
        "orders": {
            "o_orderkey": o_orderkey, "o_custkey": o_custkey, "o_totalprice": o_totalprice,
            "o_orderdate": o_orderdate, "o_shippriority": o_shippriority,
        },
        "partsupp": {
            "ps_partkey": ps_partkey, "ps_suppkey": ps_suppkey,
            "ps_availqty": ps_availqty, "ps_supplycost": ps_supplycost,
        },
        "n_supp": n_supp,
    }


def np_join(lk: np.ndarray, rk: np.ndarray):
    """All equal-key (left, right) index pairs of two int64 key arrays."""
    r_order = np.argsort(rk, kind="stable")
    rs = rk[r_order]
    lo = np.searchsorted(rs, lk, "left")
    cnt = np.searchsorted(rs, lk, "right") - lo
    li = np.repeat(np.arange(len(lk)), cnt)
    off = np.arange(len(li)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return li, r_order[lo[li] + off]


def expected_rows(data):
    li, od, ps = data["lineitem"], data["orders"], data["partsupp"]
    a, b = np_join(li["l_orderkey"], od["o_orderkey"])
    q_ord = {"l_extendedprice": li["l_extendedprice"][a], "o_custkey": od["o_custkey"][b]}
    s = data["n_supp"] + 1
    a, b = np_join(li["l_partkey"] * s + li["l_suppkey"], ps["ps_partkey"] * s + ps["ps_suppkey"])
    q_ps = {"l_quantity": li["l_quantity"][a], "ps_supplycost": ps["ps_supplycost"][b]}
    return q_ord, q_ps


def canonical(rows: dict) -> dict:
    """Columns reordered by a lexsort of all of them (first column first):
    equal multisets of rows give equal canonical columns. Numeric columns
    are stable-sorted on a card when one is visible (the CPU tests call this
    too), one pass a column, last column first, as `np.lexsort` orders them
    (NaN last); others on the host."""
    import torch

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    names = list(rows)
    n = len(rows[names[0]]) if names else 0
    order = torch.arange(n, device=dev)
    for name in reversed(names):
        col = np.asarray(rows[name])
        if col.dtype.kind in "biuf":
            if col.dtype.kind == "b":
                col = col.view(np.uint8)
            keys = torch.from_numpy(np.ascontiguousarray(col)).to(dev)[order]
            order = order[torch.sort(keys, stable=True).indices]
        else:
            host = order.cpu().numpy()
            order = torch.from_numpy(host[np.argsort(col[host], kind="stable")]).to(dev)
    order = order.cpu().numpy()
    return {name: np.asarray(rows[name])[order] for name in names}


def same_multiset(got: dict, want_canonical: dict) -> bool:
    if list(got) != list(want_canonical):
        return False
    got = canonical(got)
    return all(np.array_equal(got[n], want_canonical[n]) for n in got)


# ---------------------------------------------------------------------------
# The slice through the port's entry points
# ---------------------------------------------------------------------------

INDEXES = [
    ("lineitem", "liOrd", ["l_orderkey"], ["l_quantity", "l_extendedprice", "l_discount"]),
    ("orders", "ordIdx", ["o_orderkey"], ["o_custkey", "o_totalprice"]),
    ("lineitem", "liPs", ["l_partkey", "l_suppkey"], ["l_quantity", "l_extendedprice"]),
    ("partsupp", "psIdx", ["ps_partkey", "ps_suppkey"], ["ps_supplycost", "ps_availqty"]),
]


def source_table(columns: dict):
    """A host table of generated columns; a (dictionary, codes) pair is a
    dictionary string column."""
    import torch

    from hyperspace_tpu_torch.engine.table import Column, Table

    cols = {}
    for n, v in columns.items():
        if isinstance(v, tuple):
            cols[n] = Column("string", torch.from_numpy(v[1]), v[0])
        else:
            cols[n] = Column.from_values(v, "cpu")
    return Table(cols)


def decoded(v):
    return v[0][v[1]] if isinstance(v, tuple) else v


def write_sources(data, base: str) -> None:
    from hyperspace_tpu_torch.engine import io as engine_io

    for name in ("lineitem", "orders", "partsupp", "customer"):
        engine_io.write_parquet(source_table(data[name]), os.path.join(base, "src", name, "part-00000.parquet"))


def build(base: str, device, warehouse=None, stages=None):
    """Sessions over the sources under `base/src`; indexes in `warehouse`.
    `stages` (a dict) gets each build's `last_build_stages()`."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.telemetry.profiling import last_build_stages

    s = hst.HyperspaceSession(warehouse=warehouse or base, device=device)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    seconds = {}
    for src, name, indexed, included in INDEXES:
        df = s.read.parquet(os.path.join(base, "src", src))
        _, seconds[name] = wall(lambda: hs.create_index(df, hst.IndexConfig(name, indexed, included)))
        if stages is not None:
            stages[name] = last_build_stages()
    hst.enable_hyperspace(s)
    return s, seconds


def cpu_index_files(base: str, name: str) -> dict:
    """`index_files` of index `name` of `INDEXES` built by a CPU session
    over the same source, in a warehouse of its own."""
    import hyperspace_tpu_torch as hst

    src, _, indexed, included = next(i for i in INDEXES if i[1] == name)
    s = hst.HyperspaceSession(warehouse=os.path.join(base, "cpu_wh"), device="cpu")
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hst.Hyperspace(s).create_index(s.read.parquet(os.path.join(base, "src", src)),
                                   hst.IndexConfig(name, indexed, included))
    return index_files(s, name)


def failed_write_leaves_nothing(base: str, name: str, after: int) -> None:
    """A build of index `name` of `INDEXES` on the card whose bucket write
    after the first `after` fails (a permanent `storage.write` fault) must
    raise, leave no index file and commit no log entry."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.exceptions import PermanentError
    from hyperspace_tpu_torch.telemetry import faults

    src, _, indexed, included = next(i for i in INDEXES if i[1] == name)
    wh = os.path.join(base, "failed_write_wh")
    s = hst.HyperspaceSession(warehouse=wh, device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    faults.reset_counters()
    try:
        with faults.inject("storage.write", rate=1.0, kind="permanent", limit=1, after=after):
            hs.create_index(s.read.parquet(os.path.join(base, "src", src)), hst.IndexConfig(name, indexed, included))
    except PermanentError as e:
        err = e
    else:
        raise AssertionError(f"main: {name}'s build with a failing bucket write did not raise")
    finally:
        writes = faults.call_count("storage.write")
        faults.reset_counters()
    leftovers = [f for _, _, fs in os.walk(os.path.join(wh, "indexes", name)) for f in fs if f.endswith(".parquet")]
    if leftovers or hs._manager.get_indexes(["ACTIVE"]):
        raise AssertionError(f"main: {name}'s failed build left {len(leftovers)} index files or a log entry")
    log(f"[main] {name}: bucket write {after + 1} of a card build failed ({err}; {writes} writes begun): "
        f"no index file, no log entry")


def index_files(s, name: str) -> dict:
    """{version directory/file name: sha256} of the data files of index
    `name` of session `s`."""
    import hyperspace_tpu_torch as hst

    e = next(e for e in hst.Hyperspace(s)._manager.get_indexes() if e.name == name)
    return {"/".join(p.split(os.sep)[-2:]): sha256(p) for p in e.content.files()}


def queries(s, base: str):
    from hyperspace_tpu_torch import col

    def rd(name):
        return s.read.parquet(os.path.join(base, "src", name))

    q_ord = rd("lineitem").join(rd("orders"), col("l_orderkey") == col("o_orderkey")).select(
        "l_extendedprice", "o_custkey"
    )
    q_ps = rd("lineitem").join(
        rd("partsupp"), (col("l_partkey") == col("ps_partkey")) & (col("l_suppkey") == col("ps_suppkey"))
    ).select("l_quantity", "ps_supplycost")
    return {"q_ord": q_ord, "q_ps": q_ps}


def scanned_indexes(df):
    from hyperspace_tpu_torch.engine.physical import BucketedIndexScanExec

    return sorted(
        n.relation.index_name for n in df.physical_plan().collect_nodes()
        if isinstance(n, BucketedIndexScanExec)
    )


def clear_caches() -> None:
    """Empty every scan cache and join memo of the port: the next run is
    uncached (what PRs before the caches printed as warm)."""
    from hyperspace_tpu_torch.engine import physical, scan_cache

    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def reset_launches(*modules) -> None:
    """Set the launch counts of the kernel wrappers `modules` to 0: their
    registry counters (`kernel.launches.<label>`), which each wrapper's
    read-only `launches` reads."""
    from hyperspace_tpu_torch.telemetry import compile_log

    compile_log.reset_launches(*(m.LABEL for m in modules))


def registry_launches() -> dict:
    """Every kernel's launch count in the metrics registry, by kernel id."""
    from hyperspace_tpu_torch.telemetry import compile_log, metrics

    return {kid: metrics.counter(f"kernel.launches.{label}").value for kid, label in compile_log.LABELS.items()}


def cache_stats() -> dict:
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine import physical, scan_cache

    return {"scan_caches": scan_cache.stats(), "memos": physical.memo_stats(), "io": engine_io.io_stats()}


def q3_agg(s, base: str):
    """Q3's revenue shape over the liOrd and ordIdx indexes."""
    from hyperspace_tpu_torch import col

    def rd(name):
        return s.read.parquet(os.path.join(base, "src", name))

    return (
        rd("lineitem").join(rd("orders"), col("l_orderkey") == col("o_orderkey"))
        .with_column("revenue", col("l_extendedprice") * (1 - col("l_discount")))
        .group_by("o_custkey")
        .agg(revenue=("revenue", "sum"), orders=("l_orderkey", "count_distinct"), lines=("*", "count"),
             top=("o_totalprice", "max"))
    )


def expected_q3_agg(data) -> dict:
    """q3_agg as a numpy group-by of the generated arrays, by ascending key."""
    li, od = data["lineitem"], data["orders"]
    a, b = np_join(li["l_orderkey"], od["o_orderkey"])
    keys, inv = np.unique(od["o_custkey"][b], return_inverse=True)
    ok, tp = li["l_orderkey"][a], od["o_totalprice"][b]
    by_order = np.lexsort((ok, inv))
    si, so = inv[by_order], ok[by_order]
    first = np.ones(len(si), bool)
    first[1:] = (si[1:] != si[:-1]) | (so[1:] != so[:-1])
    by_price = np.lexsort((tp, inv))
    last = np.append(np.nonzero(np.diff(inv[by_price]))[0], len(by_price) - 1)
    return {
        "o_custkey": keys,
        "revenue": np.bincount(inv, weights=li["l_extendedprice"][a] * (1 - li["l_discount"][a])),
        "orders": np.bincount(si[first], minlength=len(keys)),
        "lines": np.bincount(inv),
        "top": tp[by_price][last],
    }


def check_q3_agg(got: dict, want: dict) -> None:
    """Keys and counts exact, the top price exact, revenue sums at rtol 1e-9."""
    order = np.argsort(got["o_custkey"], kind="stable")
    got = {n: np.asarray(v)[order] for n, v in got.items()}
    for n in ("o_custkey", "orders", "lines", "top"):
        if not np.array_equal(got[n].astype(want[n].dtype), want[n]):
            raise AssertionError(f"q3_agg: {n} differs from the numpy group-by")
    if not np.allclose(got["revenue"].astype(np.float64), want["revenue"], rtol=1e-9, atol=0):
        raise AssertionError("q3_agg: revenue sums differ from the numpy group-by beyond rtol 1e-9")


def check_answer(name: str, n: int, out, want: dict, want_agg: dict) -> None:
    """Phase main's checks of one query's count `n` and collected rows `out`
    against numpy: q_ord and q_ps as multisets (`want`: canonical rows by
    query), q3_agg's groups (`check_q3_agg`)."""
    if name == "q3_agg":
        check_q3_agg(out.to_numpy(), want_agg)
        if n != len(want_agg["o_custkey"]):
            raise AssertionError(f"q3_agg: {n} groups, numpy has {len(want_agg['o_custkey'])}")
    elif n != len(want[name][next(iter(want[name]))]):
        raise AssertionError(f"{name}: count {n} != numpy join")
    elif not same_multiset(out.to_numpy(), want[name]):
        raise AssertionError(f"{name}: collected rows differ from the numpy join")


def run_p50(fn, runs: int, uncached: bool):
    """(last output, median seconds) of `runs` calls of `fn`, each after
    emptying the caches when `uncached`."""
    seconds = []
    for _ in range(runs):
        if uncached:
            clear_caches()
        out, t = wall(fn)
        seconds.append(t)
    return out, float(np.median(seconds))


def phase_main(torch, data, base: str):
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort

    want = {n: canonical(rows) for n, rows in zip(("q_ord", "q_ps"), expected_rows(data))}
    want_agg = expected_q3_agg(data)
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    stages = {}
    s, build_s = build(base, DEVICE, stages=stages)
    for name, st in stages.items():
        log(f"[main] {name} build stages {json.dumps(st)}")
        card_check(st["mode"] == "pipelined-device", f"main: {name} was not built on the card's route: {st}")
    log(f"[main] build seconds {json.dumps(build_s)}")
    cpu_files, cpu_s = wall(lambda: cpu_index_files(base, "ordIdx"))
    if index_files(s, "ordIdx") != cpu_files:
        raise AssertionError("main: ordIdx's builds on the card and on the CPU wrote different files")
    log(f"[main] ordIdx: {len(cpu_files)} files sha256-equal to a CPU session's build ({cpu_s:.2f} s on the CPU)")
    failed_write_leaves_nothing(base, "ordIdx", after=20)
    qs = dict(queries(s, base), q3_agg=q3_agg(s, base))
    expect_idx = {"q_ord": ["liOrd", "ordIdx"], "q_ps": ["liPs", "psIdx"], "q3_agg": ["liOrd", "ordIdx"]}

    def check(name, n, out):
        check_answer(name, n, out, want, want_agg)

    times = {}
    for name, df in qs.items():
        if scanned_indexes(df) != expect_idx[name]:
            raise AssertionError(f"{name}: the plan does not scan the indexes:\n{df.explain_string()}")
        k1, k2 = cuda_sort.launches, cuda_probe.launches
        clear_caches()
        n, t_count = wall(df.count)
        clear_caches()
        out, t_collect = wall(df.collect)
        check(name, n, out)
        t = {"rows": n, "count_cold_s": t_count, "collect_cold_s": t_collect}
        out, t["uncached_p50_s"] = run_p50(df.collect, 3, uncached=True)
        check(name, n, out)
        engine_io.reset_io_stats()
        clear_caches()
        _, t["uncached_run_s"] = wall(df.collect)
        t["uncached_scan_split_s"] = engine_io.io_stats()["seconds"]
        n, t["count_uncached_p50_s"] = run_p50(df.count, 3, uncached=True)
        out, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
        n, t["count_cached_p50_s"] = run_p50(df.count, 3, uncached=False)
        check(name, n, out)
        d1, d2 = cuda_sort.launches - k1, cuda_probe.launches - k2
        if d2 == 0 or (name == "q_ps" and d1 == 0):
            raise AssertionError(f"{name}: kernels not launched (K1 {d1}, K2 {d2})")
        t.update(k1_launches=d1, k2_launches=d2)
        times[name] = t
        log(f"[main] {name} {json.dumps(t)}")
    clear_caches()
    first = qs["q3_agg"].collect()
    clear_caches()
    second = qs["q3_agg"].collect()
    for n in first.column_names:
        a, b = first.column(n), second.column(n)
        if a.data.numpy().tobytes() != b.data.numpy().tobytes() or (a.validity is None) != (b.validity is None):
            raise AssertionError(f"q3_agg: two uncached runs differ in the bits of {n}")
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    log(f"[main] counts, rows and q3_agg's groups equal numpy; two q3_agg runs are bitwise equal; "
        f"launches {json.dumps(launches)}")
    log(f"[main] caches and memos {json.dumps(cache_stats())}")
    for name in ("q_ord", "q_ps"):
        clear_caches()
        log(f"[main] {name} uncached collect breakdown {json.dumps(stage_breakdown(torch, qs[name]))}")
        log(f"[main] {name} cached collect breakdown {json.dumps(cached_breakdown(qs[name]))}")
    for uncached in (True, False):
        label = "uncached" if uncached else "cached"
        log(f"[main] q3_agg {label} collect breakdown {json.dumps(agg_breakdown(qs['q3_agg'], uncached))}")
    return launches, build_s, times


@contextlib.contextmanager
def env_flags(**flags):
    """Environment flags set inside the block and put back after it."""
    old = {k: os.environ.get(k) for k in flags}
    os.environ.update(flags)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# The co-bucketed join's dense layout (HYPERSPACE_JOIN_SIZE_CLASSES=0)
# ---------------------------------------------------------------------------

DENSE_HOT_SHARE = 0.10  # lineitem's rows moved to one orderkey (this phase's choice)
DENSE_NULL_SHARE = 0.01  # orders' keys nulled in the hash-mode pair (as phase strings nulls o_custkey)
DENSE_INDEXES = [
    ("lineitem_skew", "liSkew", ["l_orderkey"], ["l_extendedprice"]),
    ("orders", "ordSkew", ["o_orderkey"], ["o_custkey"]),
    ("orders_null_key", "ordNullKey", ["o_orderkey_n"], ["o_custkey"]),
]


def skew_sources(torch, data, base: str, seed: int) -> dict:
    """Phase dense's skewed pair's sources: lineitem's l_orderkey with 10% of
    its rows (a permutation of `RandomState(seed + 2)`) moved to the middle
    order's key, with l_extendedprice; and orders' o_orderkey with 1% nulls
    (`RandomState(seed + 3)`; the hot order kept), with o_custkey. Returns
    the skewed keys and the validity."""
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.table import Column, Table

    li, od = data["lineitem"], data["orders"]
    n = len(li["l_orderkey"])
    hot_row = len(od["o_orderkey"]) // 2
    l_orderkey = li["l_orderkey"].copy()
    l_orderkey[np.random.RandomState(seed + 2).permutation(n)[: int(n * DENSE_HOT_SHARE)]] = od["o_orderkey"][hot_row]
    valid = np.random.RandomState(seed + 3).rand(len(od["o_orderkey"])) >= DENSE_NULL_SHARE
    valid[hot_row] = True
    engine_io.write_parquet(source_table({"l_orderkey": l_orderkey, "l_extendedprice": li["l_extendedprice"]}),
                            os.path.join(base, "src", "lineitem_skew", "part-00000.parquet"))
    nullable = Table({
        "o_orderkey_n": Column("int64", torch.from_numpy(np.where(valid, od["o_orderkey"], 0)), None,
                               torch.from_numpy(valid)),
        "o_custkey": Column.from_values(od["o_custkey"], "cpu"),
    })
    engine_io.write_parquet(nullable, os.path.join(base, "src", "orders_null_key", "part-00000.parquet"))
    return {"l_orderkey": l_orderkey, "valid": valid}


def dense_kernel_rows(torch, join, s, pair: str, calls: list) -> list:
    """K1 and K2 at a dense hash-mode pair's shapes on the card: K1 on each
    side's [B, cap] matrix (rebuilt from the join's cached key64 and bucket
    bounds) and K2 on the pair's sorted reps in the probe's orientation, each
    against its plain version (max_abs_err over every output), timed beside
    the library call (median of 3 alternating windows of 3 calls) and the
    bound. `calls`: the (kernel, shape) of each of the pair's launches on the
    phase's main path; a row's launches are those at its shape."""
    from hyperspace_tpu_torch.engine import physical
    from hyperspace_tpu_torch.engine.physical import ExecContext
    from hyperspace_tpu_torch.ops import bucket_join, cuda_probe, cuda_sort

    def max_err(got, ref) -> int:
        return max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max()) for g, r in zip(got, ref))

    left, right, ls, rs, _, _ = join._sides(ExecContext(s))
    out = []
    for table, starts, keys in ((left, ls, join.left_keys), (right, rs, join.right_keys)):
        cap = bucket_join._cap_pow2(int(np.diff(starts).max()))
        key64 = physical._table_key64(table, list(keys))
        padded, _ = bucket_join._dense_scatter(torch.clamp(key64, max=PAD - 1), starts, cap)
        err = max_err(cuda_sort.sort_rows(padded), cuda_sort.sort_rows_plain(padded))
        shape = list(padded.shape)
        b_ms, b_by = bound(padded.numel() * (8 + 8 + 4), padded.numel() * np.log2(max(cap, 2)))
        ms, library_ms = paired_ms(lambda: cuda_sort.sort_rows(padded),
                                   lambda: torch.sort(padded, dim=1, stable=True), windows=3, iters=3)
        out.append({"kernel": "K1", "pair": pair, "shape": shape, "launches": calls.count(("K1", shape)), "ms": ms,
                    "library_ms": library_ms, "plain_ms": cuda_ms(lambda: cuda_sort.sort_rows_plain(padded), 3, 1),
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err})
        del padded
    a, b, _ = bucket_join.probe_orientation(*join._reconciled_reps(left, right, ls, rs))
    ak, bk = bucket_join.probe_keys_promoted(a.keys, b.keys)
    err = max_err(cuda_probe.range_probe(ak, bk, a.lengths, b.lengths),
                  cuda_probe.range_probe_plain(ak, bk, a.lengths, b.lengths))
    n_l, n_r = int(a.lengths.sum()), int(b.lengths.sum())
    b_ms, b_by = bound(8 * n_l + 8 * n_r + 16 * ak.shape[0] + 8 * ak.numel(),
                       2 * n_l * np.log2(max(int(b.lengths.max()), 2)))
    ms, library_ms = paired_ms(lambda: cuda_probe.range_probe(ak, bk, a.lengths, b.lengths),
                               lambda: (torch.searchsorted(bk, ak), torch.searchsorted(bk, ak, right=True)),
                               windows=3, iters=3)
    shape = [list(ak.shape), list(bk.shape)]
    out.append({"kernel": "K2", "pair": pair, "shape": shape, "launches": calls.count(("K2", shape)), "ms": ms,
                "library_ms": library_ms,
                "plain_ms": cuda_ms(lambda: cuda_probe.range_probe_plain(ak, bk, a.lengths, b.lengths), 1, 1),
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err})
    return out


def phase_dense(torch, data, base: str, seed: int, main_times=None):
    """The co-bucketed join's dense layout at main's width (see the module
    docstring)."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch import col
    from hyperspace_tpu_torch.engine import physical
    from hyperspace_tpu_torch.engine.physical import SortMergeJoinExec
    from hyperspace_tpu_torch.ops import bucket_join, cuda_hash, cuda_probe, cuda_sort
    from hyperspace_tpu_torch.telemetry import metrics

    log(f"[dense] {nvidia_smi_line()}")
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    calls = []  # (kernel, shape) of each K1 / K2 call the engine makes in this phase
    real_sort, real_probe = bucket_join.sort_rows, bucket_join.probe_ranges

    def sort_spy(keys):
        calls.append(("K1", list(keys.shape)))
        return real_sort(keys)

    def probe_spy(ls, rs, l_len, r_len):
        calls.append(("K2", [list(ls.shape), list(rs.shape)]))
        return real_probe(ls, rs, l_len, r_len)

    def at_hot_cap(kid: str, shape) -> bool:
        """A K1 call, or a K2 call's build side, at the skewed pair's hot cap."""
        return (shape[1] if kid == "K1" else shape[1][1]) >= hot_cap

    def pads() -> dict:
        return {site: sum(metrics.counter(f"pad.{site}.bytes_{p}").value for p in ("payload", "padded"))
                for site in ("join_buckets", "join_class")}

    def shapes_since(mark: int) -> dict:
        seen = {}
        for kid, shape in calls[mark:]:
            key = f"{kid} {json.dumps(shape)}"
            seen[key] = seen.get(key, 0) + 1
        return seen

    want = {n: canonical(rows) for n, rows in zip(("q_ord", "q_ps"), expected_rows(data))}
    want_agg = expected_q3_agg(data)
    skew = skew_sources(torch, data, base, seed)
    hot_cap = bucket_join._cap_pow2(int(np.bincount(skew["l_orderkey"]).max()))  # 1,048,576 at SF1
    od, li = data["orders"], data["lineitem"]
    a, b = np_join(skew["l_orderkey"], od["o_orderkey"])
    want_skew = {"value": canonical({"l_extendedprice": li["l_extendedprice"][a], "o_custkey": od["o_custkey"][b]})}
    kept = np.nonzero(skew["valid"])[0]
    a, b = np_join(skew["l_orderkey"], od["o_orderkey"][kept])
    want_skew["hash"] = canonical({"l_extendedprice": li["l_extendedprice"][a], "o_custkey": od["o_custkey"][kept[b]]})
    bucket_join.sort_rows, bucket_join.probe_ranges = sort_spy, probe_spy
    try:
        # (a) main's q_ord, q_ps and q3_agg on main's indexes, dense, beside main's classed runs.
        s = hst.HyperspaceSession(warehouse=base, device=DEVICE)
        hst.enable_hyperspace(s)
        qs = dict(queries(s, base), q3_agg=q3_agg(s, base))
        times, q_calls = {}, {}
        for name, df in qs.items():
            with env_flags(HYPERSPACE_JOIN_SIZE_CLASSES="1"):
                clear_caches()
                classed = df.collect()
            with env_flags(HYPERSPACE_JOIN_SIZE_CLASSES="0"):
                mark, k1, k2, p0 = len(calls), cuda_sort.launches, cuda_probe.launches, pads()
                clear_caches()
                n, t_count = wall(df.count)
                clear_caches()
                out, t_collect = wall(df.collect)
                check_answer(name, n, out, want, want_agg)
                shapes = shapes_since(mark)
                t = {"rows": n, "count_cold_s": t_count, "collect_cold_s": t_collect}
                out, t["uncached_p50_s"] = run_p50(df.collect, 3, uncached=True)
                check_answer(name, n, out, want, want_agg)
                out, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
                n, t["count_cached_p50_s"] = run_p50(df.count, 3, uncached=False)
                check_answer(name, n, out, want, want_agg)
                p1 = pads()
                q_calls[name] = calls[mark:]
            if name == "q3_agg":
                got, other = out.to_numpy(), classed.to_numpy()
                order, o2 = np.argsort(got["o_custkey"], kind="stable"), np.argsort(other["o_custkey"], kind="stable")
                same = all(np.array_equal(got[c][order], other[c][o2]) for c in ("o_custkey", "orders", "lines", "top"))
                same = same and np.allclose(got["revenue"][order], other["revenue"][o2], rtol=1e-9, atol=0)
            else:
                same = same_multiset(out.to_numpy(), canonical(classed.to_numpy()))
            if not same:
                raise AssertionError(f"dense {name}: the dense answer differs from the classed one")
            t.update(k1_launches=cuda_sort.launches - k1, k2_launches=cuda_probe.launches - k2,
                     cold_shapes=shapes, pad_bytes={k: p1[k] - p0[k] for k in p1})
            if t["pad_bytes"]["join_class"] or not t["pad_bytes"]["join_buckets"]:
                raise AssertionError(f"dense {name}: the classed layout ran under =0: {t['pad_bytes']}")
            if not t["k2_launches"] or (name == "q_ps") != bool(t["k1_launches"]):
                raise AssertionError(f"dense {name}: K1 {t['k1_launches']}, K2 {t['k2_launches']} launches")
            if main_times is not None and name in main_times:
                t["main_classed"] = {k: main_times[name][k] for k in ("uncached_p50_s", "cached_p50_s",
                                                                    "count_cached_p50_s")}
            times[name] = t
            log(f"[dense] {name} {json.dumps(t)}")

        # (b) the skewed pair, value mode (orders) and hash mode (orders with null keys).
        sk = hst.HyperspaceSession(warehouse=os.path.join(base, "dense"), device=DEVICE)
        sk.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
        hs = hst.Hyperspace(sk)
        build_s = {}
        for src, name, indexed, included in DENSE_INDEXES:
            df = sk.read.parquet(os.path.join(base, "src", src))
            _, build_s[name] = wall(lambda: hs.create_index(df, hst.IndexConfig(name, indexed, included)))
        hst.enable_hyperspace(sk)
        log(f"[dense] skewed pair builds (s) {json.dumps(build_s)}")

        def rd(t):
            return sk.read.parquet(os.path.join(base, "src", t))

        pairs = {
            "value": (rd("lineitem_skew").join(rd("orders"), col("l_orderkey") == col("o_orderkey")),
                      ["liSkew", "ordSkew"]),
            "hash": (rd("lineitem_skew").join(rd("orders_null_key"), col("l_orderkey") == col("o_orderkey_n")),
                     ["liSkew", "ordNullKey"]),
        }
        skewed, dense_calls = {}, []
        for pair, (df, indexes) in pairs.items():
            df = df.select("l_extendedprice", "o_custkey")
            if scanned_indexes(df) != indexes:
                raise AssertionError(f"dense {pair}: the plan does not scan {indexes}:\n{df.explain_string()}")
            for layout, flag in (("classed", "1"), ("dense", "0")):
                with env_flags(HYPERSPACE_JOIN_SIZE_CLASSES=flag):
                    mark, k1, k2, p0 = len(calls), cuda_sort.launches, cuda_probe.launches, pads()
                    clear_caches()
                    out, t_cold = wall(df.collect)
                    if not same_multiset(out.to_numpy(), want_skew[pair]):
                        raise AssertionError(f"dense skewed {pair} {layout}: rows differ from the numpy join")
                    t = {"rows": out.num_rows, "collect_cold_s": t_cold, "k1_launches": cuda_sort.launches - k1,
                         "k2_launches": cuda_probe.launches - k2, "cold_shapes": shapes_since(mark)}
                    p1 = pads()
                    t["pad_bytes"] = {k: p1[k] - p0[k] for k in p1}
                    out, t["uncached_p50_s"] = run_p50(df.collect, 3, uncached=True)
                    out, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
                    n, t["count_cached_p50_s"] = run_p50(df.count, 3, uncached=False)
                    if n != out.num_rows or not same_multiset(out.to_numpy(), want_skew[pair]):
                        raise AssertionError(f"dense skewed {pair} {layout}: rows or count differ from numpy's")
                hot = [kid for kid, shape in calls[mark:] if at_hot_cap(kid, shape)]
                if layout == "dense":
                    if t["pad_bytes"]["join_class"] or (pair == "hash") != bool(t["k1_launches"]) or not hot:
                        raise AssertionError(f"dense skewed {pair}: not the dense layout at the hot cap: {t}")
                    dense_calls += calls[mark:]
                elif t["pad_bytes"]["join_buckets"]:
                    raise AssertionError(f"dense skewed {pair}: the classed run padded the dense layout")
                t["device_cache"] = physical.device_cache_stats()
                skewed[f"{pair}/{layout}"] = t
                log(f"[dense] skewed {pair} {layout} {json.dumps(t)}")
        # before the kernel checks' launches
        launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    finally:
        bucket_join.sort_rows, bucket_join.probe_ranges = real_sort, real_probe
    kernel_rows = []
    with env_flags(HYPERSPACE_JOIN_SIZE_CLASSES="0"):
        for pair, session, df, pair_calls in (("q_ps", s, qs["q_ps"], q_calls["q_ps"]),
                                              ("skew", sk, pairs["hash"][0], dense_calls)):
            join = next(n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec))
            kernel_rows += dense_kernel_rows(torch, join, session, pair, pair_calls)
    for row in kernel_rows:
        if row["max_abs_err"] != 0:
            raise AssertionError(f"dense: {row['kernel']} disagrees with its plain version: {row}")
        log(f"[dense] {json.dumps(row)}")
    log(f"[dense] q_ord, q_ps, q3_agg and the skewed pair equal numpy under both layouts; launches "
        f"{json.dumps(launches)}; {nvidia_smi_line()}")
    clear_caches()
    return launches, times, skewed, kernel_rows


MESH_SHARDS = 4  # the virtual mesh's shards when one card is visible


def mesh_indexes() -> list:
    """Phase mesh's indexes: q3_agg's (liOrd, ordIdx) and Q3's (liQ3, ordQ3)."""
    return [i for i in INDEXES if i[1] in ("liOrd", "ordIdx")] + Q3_INDEXES


def exchange_traffic() -> dict:
    from hyperspace_tpu_torch.telemetry import metrics

    return {c: metrics.counter(f"parallel.exchange.{c}").value for c in ("count", "rows", "bytes_payload",
                                                                          "bytes_moved")}


def mesh_builds(base: str, warehouse: str, names) -> tuple:
    """Builds of the `mesh_indexes()` named in `names` by a card session in
    `warehouse`: (session, seconds, each build's stages and exchange traffic)."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.telemetry.profiling import last_build_stages

    s = hst.HyperspaceSession(warehouse=warehouse, device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    seconds, info = {}, {}
    for src, name, indexed, included in mesh_indexes():
        if name not in names:
            continue
        df = s.read.parquet(os.path.join(base, "src", src))
        t0 = exchange_traffic()
        _, seconds[name] = wall(lambda: hs.create_index(df, hst.IndexConfig(name, indexed, included)))
        t1 = exchange_traffic()
        st = last_build_stages()
        info[name] = {"mode": st["mode"], "sort_route": st["sort_route"], "sort_s": st.get("sort_s"),
                      **{k: t1[k] - t0[k] for k in t0}}
    return s, seconds, info


def mesh_kernel_shapes(torch, left, right) -> list:
    """K1 and K2 at one shard's shapes of a mesh probe (shard 0 of the
    blocks `left` and `right`), each against its plain version (tolerance
    0) and timed beside the library call and the bound."""
    from hyperspace_tpu_torch.ops import cuda_probe, cuda_sort
    from hyperspace_tpu_torch.ops.bucket_join import _pad_scatter

    sides = []
    for blocks in (left, right):
        lst = blocks.lstarts[0]
        lens = lst[1:] - lst[:-1]
        sides.append((_pad_scatter(blocks.blocks[0], lst[:-1], lens, blocks.cap), lens))
    shapes = []
    for padded, lens in sides:
        check_sort(torch, cuda_sort, padded.cpu().numpy())
        rows, cap = padded.shape
        b_ms, b_by = bound(rows * cap * (8 + 8 + 4), rows * cap * np.log2(max(cap, 2)))
        ms, library_ms = paired_ms(lambda: cuda_sort.sort_rows(padded), lambda: torch.sort(padded, dim=1, stable=True))
        shapes.append({"kernel": "K1", "shape": [rows, cap], "role": "mesh shard sort", "ms": ms,
                       "library_ms": library_ms, "plain_ms": cuda_ms(lambda: cuda_sort.sort_rows_plain(padded)),
                       "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0})
    (lp, l_len), (rp, r_len) = sides
    if lp.shape[1] > rp.shape[1]:  # the smaller cap probes into the larger, as the probe does
        (lp, l_len), (rp, r_len) = (rp, r_len), (lp, l_len)
    ls, rs = cuda_sort.sort_rows(lp)[0], cuda_sort.sort_rows(rp)[0]
    check_probe(torch, cuda_probe, *(x.cpu().numpy() for x in (ls, rs, l_len, r_len)))
    n_l, n_r, rows = int(l_len.sum()), int(r_len.sum()), ls.shape[0]
    b_ms, b_by = bound(8 * n_l + 8 * n_r + 16 * rows + 8 * ls.numel(), 2 * n_l * np.log2(max(int(r_len.max()), 2)))
    ms, library_ms = paired_ms(lambda: cuda_probe.range_probe(ls, rs, l_len, r_len),
                               lambda: (torch.searchsorted(rs, ls), torch.searchsorted(rs, ls, right=True)))
    shapes.append({"kernel": "K2", "shape": [list(ls.shape), list(rs.shape)], "role": "mesh shard probe", "ms": ms,
                   "library_ms": library_ms,
                   "plain_ms": cuda_ms(lambda: cuda_probe.range_probe_plain(ls, rs, l_len, r_len), iters=3, warmup=1),
                   "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0})
    return shapes


def phase_mesh(torch, data, base: str):
    """The device mesh at the main phase's width (see the module docstring)."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch import col
    from hyperspace_tpu_torch.engine.physical import ShuffleExchangeExec, SortMergeJoinExec
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort
    from hyperspace_tpu_torch.parallel import table_ops, virtual_devices

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        where, ctx, shards = f"all {n_cards} cards", contextlib.nullcontext(), n_cards
    else:
        where, ctx, shards = f"a virtual {MESH_SHARDS}-shard mesh on one card", \
            virtual_devices(MESH_SHARDS, DEVICE), MESH_SHARDS
    log(f"[mesh] {nvidia_smi_line()}; the mesh: {where}")
    want_agg, want_q3 = expected_q3_agg(data), expected_q3(data)
    want_ord = canonical(expected_rows(data)[0])
    names = [i[1] for i in mesh_indexes()]
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    probes, nested = [], []
    real_probe = table_ops.probe_dist_blocks

    def timed_probe(mesh, left, right):
        """The engine's probe, timed on the card, its blocks kept (its own
        call with the sides swapped is part of it)."""
        if nested:
            return real_probe(mesh, left, right)
        nested.append(True)
        k1, k2 = cuda_sort.launches, cuda_probe.launches
        try:
            out, t = wall(lambda: real_probe(mesh, left, right))
        finally:
            nested.clear()
        probes.append({"s": t, "k1": cuda_sort.launches - k1, "k2": cuda_probe.launches - k2,
                       "shards": list(table_ops.LAST_PROBE), "blocks": (left, right)})
        return out

    exchanges = []
    real_exchange = ShuffleExchangeExec.exchange_table

    def timed_exchange(self, mesh, t, ppd=8):
        out, sec = wall(lambda: real_exchange(self, mesh, t, ppd))
        exchanges.append(sec)
        return out

    # (a) single-device builds first (HYPERSPACE_DISTRIBUTED=0), then the mesh's.
    with env_flags(HYPERSPACE_DISTRIBUTED="0"):
        one, one_s, one_info = mesh_builds(base, os.path.join(base, "mesh_one"), names)
    card_check(all(i["mode"] == "pipelined-device" for i in one_info.values()), f"mesh: {one_info}")
    table_ops.probe_dist_blocks = timed_probe
    ShuffleExchangeExec.exchange_table = timed_exchange
    try:
        with ctx:
            s, mesh_s, info = mesh_builds(base, os.path.join(base, "mesh"), names)
            mesh = s.mesh_for(len(data["lineitem"]["l_orderkey"]))
            if mesh is None or mesh.size != shards:
                raise AssertionError(f"mesh: the session's mesh is {mesh}")
            with env_flags(HYPERSPACE_ENCODED_DEVICE="0", HYPERSPACE_PACKED_CODES="0"):
                flat, flat_s, flat_info = mesh_builds(base, os.path.join(base, "mesh_flat"), ["liOrd", "ordIdx"])
            for name, st in list(info.items()) + [(f"{n} (flat wire)", st) for n, st in flat_info.items()]:
                if st["mode"] != "mesh" or st["count"] != 1 or st["rows"] == 0:
                    raise AssertionError(f"mesh: {name} was not built through the exchange: {st}")
            for name in names:
                want = index_files(one, name)
                if index_files(s, name) != want or (name in flat_info and index_files(flat, name) != want):
                    raise AssertionError(f"mesh: {name}'s mesh-built files differ from the single-device build")
            seconds = {"mesh": mesh_s, "single_device": one_s, "mesh_flat_wire": flat_s}
            log(f"[mesh] build seconds {json.dumps(seconds)}")
            log(f"[mesh] builds (exchange traffic, sort stage) {json.dumps({'mesh': info, 'flat_wire': flat_info})}")
            log(f"[mesh] {len(names)} indexes' part files sha256-equal to the single-device builds (flat wire: "
                f"liOrd, ordIdx too)")

            # (b) Q3's aggregate and Q3 over the sharded probe, q_ord disabled over the exchange.
            hst.enable_hyperspace(s)

            def rd(t):
                return s.read.parquet(os.path.join(base, "src", t))

            def check_ord(out):
                if not same_multiset(out.to_numpy(), want_ord):
                    raise AssertionError("mesh q_ord_disabled: rows differ from the numpy join")

            q_ord = rd("lineitem").join(rd("orders"), col("l_orderkey") == col("o_orderkey"))
            qs = {
                "q3_agg": (q3_agg(s, base), lambda out: check_q3_agg(out.to_numpy(), want_agg)),
                "q3": (q3_query(rd, col), lambda out: check_q3("mesh q3", out.to_numpy(), want_q3)),
                "q_ord_disabled": (q_ord.select("l_extendedprice", "o_custkey"), check_ord),
            }
            times = {}
            for name, (df, check) in qs.items():
                (hst.disable_hyperspace if name == "q_ord_disabled" else hst.enable_hyperspace)(s)
                joins = [n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec)]
                if (name == "q_ord_disabled") == any(j.bucketed for j in joins):
                    raise AssertionError(f"mesh {name}: joins {[j.bucketed for j in joins]}:\n{df.explain_string()}")
                del probes[:], exchanges[:]
                t0, k1, k2 = exchange_traffic(), cuda_sort.launches, cuda_probe.launches
                clear_caches()
                out, t_cold = wall(df.collect)
                check(out)
                t1 = exchange_traffic()
                t = {"rows": out.num_rows, "collect_cold_s": t_cold, "exchanges": t1["count"] - t0["count"],
                     "exchange_bytes_payload": t1["bytes_payload"] - t0["bytes_payload"],
                     "exchange_bytes_moved": t1["bytes_moved"] - t0["bytes_moved"],
                     "probes": len(probes), "probe_s": [round(p["s"], 6) for p in probes],
                     "exchange_s": [round(x, 6) for x in exchanges],
                     "k1_launches": cuda_sort.launches - k1, "k2_launches": cuda_probe.launches - k2}
                if name != "q_ord_disabled":
                    if not probes or any(len(p["shards"]) != mesh.size for p in probes):
                        raise AssertionError(f"mesh {name}: the sharded probe did not run: {probes}")
                    card_check(all(p["k1"] == 2 * mesh.size and p["k2"] == mesh.size for p in probes),
                               f"mesh {name}: K1 and K2 did not launch on every shard: "
                               f"{[(p['k1'], p['k2']) for p in probes]}")
                    t["shards"] = probes[0]["shards"]
                if name != "q3_agg" and t["exchanges"] < 2:
                    raise AssertionError(f"mesh {name}: the general join did not exchange both sides: {t}")
                out, t["uncached_p50_s"] = run_p50(df.collect, 3, uncached=True)
                check(out)
                out, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
                check(out)
                n = df.count()
                if n != out.num_rows:
                    raise AssertionError(f"mesh {name}: count() {n} != {out.num_rows} rows")
                times[name] = t
                log(f"[mesh] {name} {json.dumps(t)}")
                log(f"[mesh] {name} uncached collect stages {json.dumps(query_stage_split(torch, df, True))}")
                if name == "q3_agg":
                    blocks = probes[0]["blocks"]
            # before the timing's launches
            launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
            for sh in mesh_kernel_shapes(torch, *blocks):
                log(f"[mesh] {json.dumps(sh)}")
            log(f"[mesh] q3_agg, q3 and q_ord disabled equal numpy over the mesh; launches {json.dumps(launches)}; "
                f"{nvidia_smi_line()}")
        if s.mesh_for(len(data["lineitem"]["l_orderkey"])) is not None and n_cards < 2:
            raise AssertionError("mesh: the virtual mesh outlived its block")
    finally:
        table_ops.probe_dist_blocks = real_probe
        ShuffleExchangeExec.exchange_table = real_exchange
    return launches, {"mesh": mesh_s, "single_device": one_s}, times


def cached_breakdown(df) -> dict:
    """Seconds of each step of one cached `collect()` of a join: the scans
    (cache hits), the pairs (a memo hit), the gather and the copy to the host."""
    from hyperspace_tpu_torch.engine.physical import ExecContext, _assemble_join

    project = df.physical_plan()
    join = project.child
    ctx = ExecContext(df.session)
    t = {}
    _, t["scan_left_s"] = wall(lambda: join.left.execute_concat(ctx))
    _, t["scan_right_s"] = wall(lambda: join.right.execute_concat(ctx))
    (left, right, li, ri), t["pairs_s"] = wall(lambda: join._pairs(ctx))
    out, t["gather_s"] = wall(lambda: _assemble_join(left, right, li, ri, join.how).select(project.column_names))
    _, t["to_host_s"] = wall(lambda: out.to("cpu"))
    return t


def agg_breakdown(df, uncached: bool) -> dict:
    """Seconds of each stage of one `collect()` of q3_agg: scan, join,
    with_column, aggregate and the copy to the host; an uncached run also
    splits its scan into parts (decode, dictionary conversion and copy to the
    device summed over the decode threads, and the concatenation)."""
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.physical import ExecContext
    from hyperspace_tpu_torch.ops.aggregate import hash_aggregate

    agg = df.physical_plan()
    with_col = agg.child
    join = with_col.child
    ctx = ExecContext(df.session)
    if uncached:
        clear_caches()
        engine_io.reset_io_stats()
    t = {}
    _, t["scan_s"] = wall(lambda: (join.left.execute_concat(ctx), join.right.execute_concat(ctx)))
    if uncached:
        t["scan_split_s"] = engine_io.io_stats()["seconds"]
    joined, t["join_s"] = wall(lambda: join.execute(ctx))
    computed, t["with_column_s"] = wall(lambda: with_col.apply(joined))
    out, t["aggregate_s"] = wall(lambda: hash_aggregate(computed, agg.group_keys, agg.aggs))
    t.update(aggregate_split(lambda: hash_aggregate(computed, agg.group_keys, agg.aggs)))
    _, t["to_host_s"] = wall(lambda: out.to("cpu"))
    t["joined_rows"], t["groups"] = joined.num_rows, out.num_rows
    return t


def aggregate_split(run) -> dict:
    """Seconds of the parts of one more aggregate (`run`): the key64 hash, the
    stable sort and group ids, the segment reductions, count_distinct, each
    timed by a host clock ended by a synchronize, and the rest (the
    representatives and the output columns)."""
    from hyperspace_tpu_torch.ops import aggregate

    names = {"key64": "key64", "_group_ids": "group_ids", "_segment_reduce": "reduce",
             "_count_distinct_sorted": "count_distinct"}
    spent = {part: 0.0 for part in names.values()}
    originals = {name: getattr(aggregate, name) for name in names}

    def timed(fn, part):
        def call(*args):
            out, seconds = wall(lambda: fn(*args))
            spent[part] += seconds
            return out
        return call

    for name, part in names.items():
        setattr(aggregate, name, timed(originals[name], part))
    try:
        _, total = wall(run)
    finally:
        for name, fn in originals.items():
            setattr(aggregate, name, fn)
    split = {f"aggregate_{part}_s": seconds for part, seconds in spent.items()}
    split["aggregate_other_s"] = total - sum(spent.values())
    return split


def stage_breakdown(torch, df) -> dict:
    """Seconds of each stage of one uncached `collect()` (the caller empties
    the caches), run step by step with a synchronize after each (the steps
    `SortMergeJoinExec` chains when its memos miss), the scan's parts, and
    the device's busy share of a whole uncached `collect()` from
    `torch.profiler`."""
    from hyperspace_tpu_torch.engine import io as engine_io

    from hyperspace_tpu_torch.engine.physical import ExecContext, _assemble_join, _classed_plan, _verify_pairs
    from hyperspace_tpu_torch.ops.bucket_join import classed_pairs, probe_classed

    project = df.physical_plan()
    join = project.child
    ctx = ExecContext(df.session)
    t = {}
    engine_io.reset_io_stats()
    (left, l_starts), t["scan_left_s"] = wall(lambda: join.left.execute_concat(ctx))
    (right, r_starts), t["scan_right_s"] = wall(lambda: join.right.execute_concat(ctx))
    t["scan_split_s"] = engine_io.io_stats()["seconds"]
    layout = lambda: _classed_plan(left, right, join.left_keys, join.right_keys, l_starts, r_starts)  # noqa: E731
    plan, t["layout_s"] = wall(layout)
    t.update(layout_split(layout))
    ranges, t["probe_s"] = wall(lambda: probe_classed(plan))
    # The probe stage is a few host calls around K2's launches: a median of 5
    # more runs beside the one above.
    t["probe_p50_s"] = float(np.median([wall(lambda: probe_classed(plan))[1] for _ in range(5)]))
    (li, ri), t["expand_s"] = wall(lambda: classed_pairs(plan, ranges))
    (li, ri), t["verify_s"] = wall(lambda: _verify_pairs(left, right, join.left_keys, join.right_keys, li, ri))
    out, t["gather_s"] = wall(lambda: _assemble_join(left, right, li, ri, join.how).select(project.column_names))
    _, t["to_host_s"] = wall(lambda: out.to("cpu"))
    t["mode"] = plan.mode
    t["classes"] = [[int(len(seg.ids)), seg.l.cap, seg.r.cap] for seg in plan.segments]
    t["outlier_buckets"] = int(len(plan.outlier_ids))
    t.update(device_busy(df))
    return t


def device_busy(df) -> dict:
    """The device's busy seconds (`torch.profiler` device self time) and
    busy share of one uncached `collect()` of `df`."""
    from torch.profiler import ProfilerActivity, profile

    clear_caches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_s = wall(df.collect)
    device_us = sum(
        getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) for e in prof.key_averages()
    )
    return {"profiled_collect_s": wall_s, "device_busy_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / wall_s if device_us else None}


def layout_split(layout) -> dict:
    """Seconds of the parts of one more run of `layout` (a `_classed_plan`
    call, its key64 memo emptied first): the key64 hashes, the pad scatters
    and K1, each timed by a host clock ended by a synchronize, and the rest
    of the stage (the joint partition, clamps, copies of the bucket bounds)."""
    from hyperspace_tpu_torch.engine import physical
    from hyperspace_tpu_torch.ops import bucket_join

    parts = [(physical, "_table_key64", "key64"), (bucket_join, "_pad_scatter", "pad_scatter"),
             (bucket_join, "sort_rows", "k1")]
    spent = {part: 0.0 for _, _, part in parts}
    originals = [getattr(module, name) for module, name, _ in parts]

    def timed(fn, part):
        def call(*args):
            out, seconds = wall(lambda: fn(*args))
            spent[part] += seconds
            return out
        return call

    for (module, name, part), fn in zip(parts, originals):
        setattr(module, name, timed(fn, part))
    physical.clear_device_memos()
    try:
        _, total = wall(layout)
    finally:
        for (module, name, _), fn in zip(parts, originals):
            setattr(module, name, fn)
    split = {f"layout_{part}_s": seconds for part, seconds in spent.items()}
    split["layout_other_s"] = total - sum(spent.values())
    split["layout_split_total_s"] = total
    return split


# ---------------------------------------------------------------------------
# TPC-H Q3 whole: a bucketed join, a general join, the aggregate, ORDER BY and
# LIMIT, with its covering indexes and with Hyperspace disabled
# ---------------------------------------------------------------------------

Q3_INDEXES = [
    ("lineitem", "liQ3", ["l_orderkey"], ["l_extendedprice", "l_discount", "l_shipdate"]),
    ("orders", "ordQ3", ["o_orderkey"], ["o_custkey", "o_orderdate", "o_shippriority"]),
]
Q3_COLUMNS = ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]


def q3_query(read, col, n: int = 10):
    """TPC-H Q3 through either package's DataFrame API (`read(table)` gives a
    source's DataFrame, `col` names a column): (lineitem shipped after the
    date ⋈ orders placed before it) ⋈ BUILDING customers, revenue summed per
    order, the `n` largest (Q3 takes 10)."""
    li = read("lineitem").filter(col("l_shipdate") > Q3_DATE)
    od = read("orders").filter(col("o_orderdate") < Q3_DATE)
    cu = read("customer").filter(col("c_mktsegment") == "BUILDING")
    return (
        li.join(od, col("l_orderkey") == col("o_orderkey"))
        .join(cu, col("o_custkey") == col("c_custkey"))
        .with_column("revenue", col("l_extendedprice") * (1 - col("l_discount")))
        .group_by("l_orderkey", "o_orderdate", "o_shippriority")
        .agg(revenue=("revenue", "sum"))
        .order_by(("revenue", False), "o_orderdate")
        .limit(n)
        .select(*Q3_COLUMNS)
    )


def expected_q3(data) -> dict:
    """Q3 of the generated arrays with numpy: every group, in Q3's order
    (revenue descending, then o_orderdate); the query keeps the first ten."""
    li, od, cu = data["lineitem"], data["orders"], data["customer"]
    seg_dict, seg = cu["c_mktsegment"]
    building = cu["c_custkey"][seg == int(np.searchsorted(seg_dict, "BUILDING"))]
    o = np.nonzero((od["o_orderdate"] < Q3_DATE) & np.isin(od["o_custkey"], building))[0]
    lines = np.nonzero(li["l_shipdate"] > Q3_DATE)[0]
    a, b = np_join(li["l_orderkey"][lines], od["o_orderkey"][o])
    a, b = lines[a], o[b]
    keys, inv = np.unique(li["l_orderkey"][a], return_inverse=True)
    revenue = np.bincount(inv, weights=li["l_extendedprice"][a] * (1 - li["l_discount"][a]))
    order_of = np.zeros(len(keys), np.int64)
    order_of[inv] = b
    date, prio = od["o_orderdate"][order_of], od["o_shippriority"][order_of]
    by = np.lexsort((date, -revenue))
    return {"l_orderkey": keys[by], "revenue": revenue[by], "o_orderdate": date[by], "o_shippriority": prio[by]}


def check_q3(label: str, got: dict, want: dict, n: int = 10) -> None:
    """`got` must be numpy's first n rows in order, revenue at rtol 1e-9. Rows
    whose sort keys tie in numpy's order (revenue within rtol 1e-9 and the
    same date) may come in any order among themselves; a tie across the n-th
    row may bring any of its members."""
    rev, date = want["revenue"], want["o_orderdate"]
    m = min(n, len(rev))
    if list(got) != Q3_COLUMNS or len(got["l_orderkey"]) != m:
        raise AssertionError(f"{label}: columns {list(got)} and {len(got['l_orderkey'])} rows, want {Q3_COLUMNS} "
                             f"and {m}")
    tie = np.isclose(rev[1:], rev[:-1], rtol=1e-9, atol=0) & (date[1:] == date[:-1])
    cls = np.concatenate([[0], np.cumsum(~tie)])
    keys = np.asarray(got["l_orderkey"])
    for c in np.unique(cls[:m]):
        pos, members = np.nonzero(cls[:m] == c)[0], np.nonzero(cls == c)[0]
        have, allowed = set(keys[pos].tolist()), set(want["l_orderkey"][members].tolist())
        if not (have <= allowed if members[-1] >= m else have == allowed):
            raise AssertionError(f"{label}: rows {pos.tolist()} hold orders {sorted(have)}, numpy {sorted(allowed)}")
    at = {k: i for i, k in enumerate(want["l_orderkey"].tolist())}
    rows = np.array([at[k] for k in keys.tolist()], np.int64)
    for name in ("o_orderdate", "o_shippriority"):
        if not np.array_equal(np.asarray(got[name]).astype(np.int64), want[name][rows].astype(np.int64)):
            raise AssertionError(f"{label}: {name} differs from numpy's Q3")
    if not np.allclose(np.asarray(got["revenue"], np.float64), want["revenue"][rows], rtol=1e-9, atol=0):
        raise AssertionError(f"{label}: revenue differs from numpy's Q3 beyond rtol 1e-9")


def query_stage_split(torch, df, uncached: bool) -> dict:
    """Seconds of one `collect()` of a query (Q3, Q13) by stage: each
    operator's own time (its call's time less its children's, every call
    ended by a synchronize), summed into the scans (with their filters), the
    bucketed join, the general join (with its exchange and sort markers), the
    aggregates (with the computed column), ORDER BY, LIMIT, the projection,
    the set operations and the copy to the host."""
    from hyperspace_tpu_torch.engine.physical import ExecContext

    plan = df.physical_plan()
    spent, stack = {}, []

    def stage(node) -> str:
        if node.name == "SortMergeJoin":
            return "bucketed_join_s" if node.bucketed else "general_join_s"
        return {
            "Scan": "scans_s", "BucketedIndexScan": "scans_s", "Filter": "scans_s", "Sort": "general_join_s",
            "ShuffleExchange": "general_join_s", "WithColumn": "aggregate_s", "HashAggregate": "aggregate_s",
            "OrderBy": "order_by_s", "Limit": "limit_s", "Project": "project_s",
            "Intersect": "set_op_s", "Except": "set_op_s", "Union": "set_op_s", "MultiwayJoin": "star_join_s",
        }[node.name]

    def wrap(node, method):
        fn = getattr(node, method)

        def call(*args):
            stack.append(0.0)
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            inner = stack.pop()
            spent[stage(node)] = spent.get(stage(node), 0.0) + dt - inner
            if stack:
                stack[-1] += dt
            return out

        setattr(node, method, call)

    for node in plan.collect_nodes():
        for method in ("execute", "execute_concat", "execute_pruned_concat"):
            if hasattr(node, method):
                wrap(node, method)
    if uncached:
        clear_caches()
    out, total = wall(lambda: plan.execute(ExecContext(df.session)))
    _, spent["to_host_s"] = wall(lambda: out.to("cpu"))
    spent["total_s"] = total + spent["to_host_s"]
    return spent


def order_by_check(torch, rows: int = 1 << 20) -> dict:
    """`OrderByExec`'s stable sorts on the card against `np.lexsort` of the
    JAX package's lanes (value, validity above it; a descending key as a
    negated dense rank), over float keys that a radix sort of raw bits would
    split: NaNs of both signs (they tie, after +inf) and ±0.0 (they tie), in
    float64 and float32, with an int key and a nullable copy. Returns the
    seconds of each order on the card."""
    from hyperspace_tpu_torch.engine.physical import OrderByExec
    from hyperspace_tpu_torch.engine.table import Column, Table

    rng = np.random.RandomState(5)
    seconds = {}
    for dtype in (np.float64, np.float32):
        pool = np.array([np.nan, -np.nan, 0.0, -0.0, 1.5, -1.5, np.inf, -np.inf], dtype)
        f = np.where(rng.rand(rows) < 0.5, pool[rng.randint(0, len(pool), rows)], rng.randn(rows).astype(dtype))
        g = rng.randint(0, 4, rows).astype(np.int64)
        valid = rng.rand(rows) >= 0.05
        fill = np.where(valid, f, 0).astype(dtype)
        t = Table({
            "f": Column.from_values(f, DEVICE),
            "g": Column.from_values(g, DEVICE),
            "fn": Column(np.dtype(dtype).name, torch.from_numpy(fill).to(DEVICE), None, torch.from_numpy(valid).to(DEVICE)),
        })
        rank = np.unique(f, return_inverse=True)[1].reshape(-1)
        fill_rank = np.unique(fill, return_inverse=True)[1].reshape(-1)
        cases = {
            "f": ([("f", True)], [f]),
            "f_desc": ([("f", False)], [-rank]),
            "g_f_desc": ([("g", True), ("f", False)], [-rank, g]),
            "fn": ([("fn", True)], [fill, valid]),
            "fn_desc_g_desc": ([("fn", False), ("g", False)], [-g, -fill_rank, ~valid]),
        }
        for name, (keys, lanes) in cases.items():
            node = OrderByExec(keys, None)
            perm, seconds[f"{np.dtype(dtype).name}_{name}_s"] = wall(lambda: node.order(t))
            if not np.array_equal(perm.cpu().numpy(), np.lexsort(tuple(lanes))):
                raise AssertionError(f"order_by {np.dtype(dtype).name} {keys}: the card's order differs from np.lexsort")
    return seconds


def phase_q3(torch, data, base: str):
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine.physical import SortMergeJoinExec
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort

    want = expected_q3(data)
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    s = hst.HyperspaceSession(warehouse=os.path.join(base, "q3"), device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    build_s = {}
    for src, name, indexed, included in Q3_INDEXES:
        df = s.read.parquet(os.path.join(base, "src", src))
        _, build_s[name] = wall(lambda: hs.create_index(df, hst.IndexConfig(name, indexed, included)))
    log(f"[q3] build seconds {json.dumps(build_s)}")
    df = q3_query(lambda t: s.read.parquet(os.path.join(base, "src", t)), hst.col)
    results, times = {}, {}
    for run in ("indexed", "disabled"):
        (hst.enable_hyperspace if run == "indexed" else hst.disable_hyperspace)(s)
        joins = [n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec)]
        kinds = sorted("bucketed" if j.bucketed else "general" for j in joins)
        expect = ["bucketed", "general"] if run == "indexed" else ["general", "general"]
        if kinds != expect or (run == "indexed" and scanned_indexes(df) != ["liQ3", "ordQ3"]):
            raise AssertionError(f"q3 {run}: joins {kinds}, want {expect}:\n{df.explain_string()}")
        k2, k6 = cuda_probe.launches, cuda_hash.launches
        clear_caches()
        out, t_cold = wall(df.collect)
        check_q3(f"q3 {run}", out.to_numpy(), want)
        t = {"rows": out.num_rows, "collect_cold_s": t_cold}
        out, t["uncached_p50_s"] = run_p50(df.collect, 3, uncached=True)
        check_q3(f"q3 {run}", out.to_numpy(), want)
        out, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
        check_q3(f"q3 {run}", out.to_numpy(), want)
        if df.count() != out.num_rows:
            raise AssertionError(f"q3 {run}: count() {df.count()} != {out.num_rows} rows")
        t["k2_launches"] = cuda_probe.launches - k2
        t["k6_launches"] = cuda_hash.launches - k6
        if run == "indexed" and t["k2_launches"] == 0:
            raise AssertionError("q3 indexed: K2 never launched")
        if t["k6_launches"] == 0:
            raise AssertionError(f"q3 {run}: K6 never launched (the aggregate's and the general join's keys)")
        results[run] = out.to_numpy()
        times[run] = t
        log(f"[q3] {run} {json.dumps(t)}")
        log(f"[q3] {run} uncached collect stages {json.dumps(query_stage_split(torch, df, True))}")
        log(f"[q3] {run} cached collect stages {json.dumps(query_stage_split(torch, df, False))}")
    a, b = results["indexed"], results["disabled"]
    ai, bi = np.argsort(a["l_orderkey"]), np.argsort(b["l_orderkey"])
    if not (np.array_equal(a["l_orderkey"][ai], b["l_orderkey"][bi])
            and np.allclose(a["revenue"][ai], b["revenue"][bi], rtol=1e-9, atol=0)
            and all(np.array_equal(a[c][ai], b[c][bi]) for c in ("o_orderdate", "o_shippriority"))):
        raise AssertionError("q3: the indexed and the disabled runs differ")
    hst.enable_hyperspace(s)
    log(f"[q3] order_by on the card equals np.lexsort with NaN and ±0.0 keys ({1 << 20} rows), seconds "
        f"{json.dumps(order_by_check(torch))}")
    top = {c: (v.tolist() if c != "revenue" else [round(float(x), 4) for x in v]) for c, v in a.items()}
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    log(f"[q3] both runs equal numpy's Q3 and each other; top rows {json.dumps(top)}; "
        f"launches {json.dumps(launches)}")
    return launches, build_s, times


# ---------------------------------------------------------------------------
# TPC-H Q13 and the other join types: outer, semi and anti joins
# ---------------------------------------------------------------------------

Q13_INDEXES = [
    ("customer", "custQ13", ["c_custkey"], []),
    ("orders", "ordQ13", ["o_custkey"], ["o_orderkey"]),
    ("orders_nullable", "ordNullQ13", ["o_custkey_n"], ["o_orderkey"]),
]
Q13_COLUMNS = ["c_count", "custdist"]
JOIN_TYPE_INDEXES = {"right": ["custQ13", "ordQ13"], "semi": ["custQ13", "ordQ13"], "anti": ["custQ13", "ordQ13"],
                     "full_nullable": ["custQ13", "ordNullQ13"]}


def q13_query(read, col):
    """TPC-H Q13 through either package's DataFrame API (`read(table)` gives
    a source's DataFrame, `col` names a column), without its `o_comment NOT
    LIKE '%special%requests%'` predicate (neither package has LIKE, and the
    generator makes no o_comment): customer LEFT OUTER JOIN orders, each
    customer's orders counted (count(o_orderkey) skips the nulls of a
    customer with none), the customers of each count counted, by custdist
    and c_count descending."""
    return (
        q13_join(read, col)
        .group_by("c_custkey").agg(c_count=("o_orderkey", "count"))
        .group_by("c_count").agg(custdist=("*", "count"))
        .order_by(("custdist", False), ("c_count", False))
    )


def q13_join(read, col):
    """Q13's outer join alone: every order beside its customer, and each
    customer with no order beside null order columns."""
    return read("customer").join(read("orders"), col("c_custkey") == col("o_custkey"), "left")


def join_type_queries(read, col) -> dict:
    """The other join types over Q13's tables (name → DataFrame): the mirror
    of Q13's join, Q4's semi join core and Q22's anti join core (customers
    with and without orders), and a full outer join of orders' o_custkey
    with 1% nulls (`key_kind_sources`) with customer."""
    cu, od = read("customer"), read("orders")
    return {
        "right": od.join(cu, col("o_custkey") == col("c_custkey"), "right").select("o_orderkey", "c_custkey"),
        "semi": cu.join(od, col("c_custkey") == col("o_custkey"), "semi").select("c_custkey"),
        "anti": cu.join(od, col("c_custkey") == col("o_custkey"), "anti").select("c_custkey"),
        "full_nullable": read("orders_nullable").join(cu, col("o_custkey_n") == col("c_custkey"), "full")
        .select("o_orderkey", "o_custkey_n", "c_custkey"),
    }


def orders_per_customer(data) -> np.ndarray:
    cu, od = data["customer"]["c_custkey"], data["orders"]["o_custkey"]
    return np.bincount(np.searchsorted(cu, od), minlength=len(cu))


def expected_q13(data) -> dict:
    """Q13 of the generated arrays with numpy: a `np.bincount` of o_custkey
    over the customers, then of those counts, by custdist and c_count
    descending (c_count is unique, so the order is total)."""
    dist = np.bincount(orders_per_customer(data))
    c_count = np.nonzero(dist)[0]
    custdist = dist[c_count]
    order = np.lexsort((-c_count, -custdist))
    return {"c_count": c_count[order].astype(np.int64), "custdist": custdist[order].astype(np.int64)}


def check_q13(label: str, got: dict, want: dict) -> None:
    """Exact integer equality, row for row."""
    if list(got) != Q13_COLUMNS or any(not np.array_equal(np.asarray(got[c]).astype(np.int64), want[c])
                                       for c in Q13_COLUMNS):
        raise AssertionError(f"{label}: {list(got)} {len(got.get('c_count', []))} rows differ from numpy's Q13 "
                             f"({len(want['c_count'])} rows)")


def expected_join_types(data, valid: np.ndarray) -> dict:
    """`join_type_queries`' rows with numpy, nulls as -1 (every key is
    positive), in any order. `valid` is o_custkey_n's validity."""
    cu, od = data["customer"]["c_custkey"], data["orders"]
    has_orders = orders_per_customer(data) > 0
    ok, ck = od["o_orderkey"], od["o_custkey"]
    lonely = cu[~has_orders]
    none = np.full(len(lonely), -1, np.int64)
    matched = np.zeros(len(cu), bool)
    matched[np.searchsorted(cu, ck[valid])] = True
    no_valid = cu[~matched]
    nulls = np.full(int((~valid).sum()), -1, np.int64)
    return {
        "right": {"o_orderkey": np.concatenate([ok, none]), "c_custkey": np.concatenate([ck, lonely])},
        "semi": {"c_custkey": cu[has_orders]},
        "anti": {"c_custkey": lonely},
        "full_nullable": {
            "o_orderkey": np.concatenate([ok[valid], ok[~valid], np.full(len(no_valid), -1, np.int64)]),
            "o_custkey_n": np.concatenate([ck[valid], nulls, np.full(len(no_valid), -1, np.int64)]),
            "c_custkey": np.concatenate([ck[valid], nulls, no_valid]),
        },
    }


def filled(table) -> dict:
    """A collected table's int64 columns on the host, -1 at nulls."""
    out = {}
    for n, c in table.columns.items():
        v = c.data.cpu().numpy().astype(np.int64)
        out[n] = v if c.validity is None else np.where(c.validity.cpu().numpy(), v, -1)
    return out


def outer_join_split(torch, df) -> dict:
    """Seconds of one uncached run of the first join in a query's plan by
    step (each ended by a synchronize): the two sides' scans, the verified
    pairs, the assembly of the join's type and, beside it, the inner
    assembly of the same pairs. `outer_extra_share` is the outer assembly's
    time over the inner one as a share of the join's scans, pairs and
    assembly."""
    from hyperspace_tpu_torch.engine.physical import ExecContext, SortMergeJoinExec, _assemble_join

    join = next(n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec))
    ctx = ExecContext(df.session)
    clear_caches()
    t = {}
    for side in ("left", "right"):
        node = getattr(join, side)
        _, t[f"scan_{side}_s"] = wall(lambda: getattr(node, "execute_concat", node.execute)(ctx))
    (left, right, li, ri), t["pairs_s"] = wall(lambda: join._pairs(ctx))
    out, t["assemble_s"] = wall(lambda: _assemble_join(left, right, li, ri, join.how))
    _, t["inner_assemble_s"] = wall(lambda: _assemble_join(left, right, li, ri, "inner"))
    total = t["scan_left_s"] + t["scan_right_s"] + t["pairs_s"] + t["assemble_s"]
    t.update(pairs=len(li), rows=out.num_rows,
             outer_extra_share=(t["assemble_s"] - t["inner_assemble_s"]) / total)
    return t


def phase_q13(torch, data, base: str, seed: int):
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine.physical import SortMergeJoinExec
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort

    valid = key_kind_sources(torch, data, base, seed)["o_custkey_n"]
    want = expected_q13(data)
    want_types = {n: canonical(rows) for n, rows in expected_join_types(data, valid).items()}
    n_cust, n_orders = len(data["customer"]["c_custkey"]), len(data["orders"]["o_orderkey"])
    outer_rows = n_orders + n_cust - int((orders_per_customer(data) > 0).sum())
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    s = hst.HyperspaceSession(warehouse=os.path.join(base, "q13"), device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    build_s = {}
    for src, name, indexed, included in Q13_INDEXES:
        df = s.read.parquet(os.path.join(base, "src", src))
        _, build_s[name] = wall(lambda: hs.create_index(df, hst.IndexConfig(name, indexed, included)))
    log(f"[q13] build seconds {json.dumps(build_s)}")

    def read(t):
        return s.read.parquet(os.path.join(base, "src", t))

    df, outer = q13_query(read, hst.col), q13_join(read, hst.col)
    results, times = {}, {}
    for run in ("indexed", "disabled"):
        (hst.enable_hyperspace if run == "indexed" else hst.disable_hyperspace)(s)
        joins = [n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec)]
        if [(j.bucketed, j.how) for j in joins] != [(run == "indexed", "left")] or (
                run == "indexed" and scanned_indexes(df) != ["custQ13", "ordQ13"]):
            raise AssertionError(f"q13 {run}: want one {'bucketed' if run == 'indexed' else 'general'} left join:\n"
                                 f"{df.explain_string()}")
        k1, k2 = cuda_sort.launches, cuda_probe.launches
        clear_caches()
        out, t_cold = wall(df.collect)
        check_q13(f"q13 {run}", out.to_numpy(), want)
        t = {"rows": out.num_rows, "collect_cold_s": t_cold}
        out, t["uncached_p50_s"] = run_p50(df.collect, 3, uncached=True)
        check_q13(f"q13 {run}", out.to_numpy(), want)
        out, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
        check_q13(f"q13 {run}", out.to_numpy(), want)
        if df.count() != out.num_rows:
            raise AssertionError(f"q13 {run}: count() {df.count()} != {out.num_rows} rows")
        n_outer = outer.count()
        if n_outer != outer_rows or outer.collect().num_rows != outer_rows:
            raise AssertionError(f"q13 {run}: the outer join gives {n_outer} rows, numpy {outer_rows}")
        t.update(outer_join_rows=n_outer, k1_launches=cuda_sort.launches - k1, k2_launches=cuda_probe.launches - k2)
        if (t["k2_launches"] > 0) != (run == "indexed") or t["k1_launches"]:
            raise AssertionError(f"q13 {run}: the indexed join must launch K2 alone, the general join no kernel: {t}")
        results[run] = out.to_numpy()
        times[run] = t
        log(f"[q13] {run} {json.dumps(t)}")
        log(f"[q13] {run} uncached collect stages {json.dumps(query_stage_split(torch, df, True))}")
        log(f"[q13] {run} cached collect stages {json.dumps(query_stage_split(torch, df, False))}")
        log(f"[q13] {run} Q13's outer join uncached split {json.dumps(outer_join_split(torch, df))}")
    if any(not np.array_equal(results["indexed"][c], results["disabled"][c]) for c in Q13_COLUMNS):
        raise AssertionError("q13: the indexed and the disabled runs differ")
    # The bare outer join keeps every customer column, c_name's dictionary of
    # 150,000 names among them (no index covers them: the general join).
    log(f"[q13] the bare outer join (all columns) uncached split {json.dumps(outer_join_split(torch, outer))}")
    hst.enable_hyperspace(s)
    for name, q in join_type_queries(read, hst.col).items():
        join = next(n for n in q.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec))
        if scanned_indexes(q) != JOIN_TYPE_INDEXES[name] or not join.bucketed:
            raise AssertionError(f"{name}: the plan does not join {JOIN_TYPE_INDEXES[name]}:\n{q.explain_string()}")
        k1, k2 = cuda_sort.launches, cuda_probe.launches
        clear_caches()
        got, t_cold = wall(q.collect)
        n = q.count()
        rows = len(next(iter(want_types[name].values())))
        if n != got.num_rows or n != rows or not same_multiset(filled(got), want_types[name]):
            raise AssertionError(f"{name}: count() {n}, {got.num_rows} rows differ from numpy's {rows}")
        t = {"how": join.how, "rows": n, "collect_cold_s": t_cold}
        _, t["cached_p50_s"] = run_p50(q.collect, 3, uncached=False)
        t.update(k1_launches=cuda_sort.launches - k1, k2_launches=cuda_probe.launches - k2)
        if not t["k2_launches"] or (name == "full_nullable") != bool(t["k1_launches"]):
            raise AssertionError(f"{name}: K2 must launch, and K1 exactly on the nullable key (hash mode): {t}")
        times[name] = t
        log(f"[q13] {name} {json.dumps(t)}")
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    top = {c: v[:5].tolist() for c, v in results["indexed"].items()}
    log(f"[q13] Q13 indexed and disabled equal numpy's Q13 and each other ({len(want['c_count'])} rows, first "
        f"{json.dumps(top)}); right, semi, anti and the nullable full outer join equal numpy; launches "
        f"{json.dumps(launches)}")
    return launches, build_s, times


def phase_identity(torch, seed: int, sf: float) -> None:
    import hyperspace_tpu_torch as hst

    data = tpch(sf, seed)
    base = tempfile.mkdtemp(prefix="hs_smoke_ident_")
    try:
        write_sources(data, base)
        results, files = {}, {}
        for i, device in enumerate(("cpu", DEVICE)):
            wh = os.path.join(base, f"warehouse{i}")
            s, _ = build(base, device, warehouse=wh)
            qs = dict(queries(s, base), q3_agg=q3_agg(s, base))
            # Q3 without its indexes (two general joins), every group in order.
            qs["q3"] = q3_query(lambda t: s.read.parquet(os.path.join(base, "src", t)), hst.col, 1_000_000)
            results[i] = {n: df.collect().to_numpy() for n, df in qs.items()}
            s, _, k3 = build_string_indexes(torch, base, device, wh)
            if device == DEVICE and k3 != {"custSeg": 1, "liShip": 1}:
                raise AssertionError(f"at SF{sf} both string builds must take K3: {k3}")
            for name, df in string_queries(s, base, range_key(data)).items():
                if index_scan(df) is None:
                    raise AssertionError(f"{name}: the plan does not scan the index:\n{df.explain_string()}")
                results[i][name] = df.collect().to_numpy()
            hs = hst.Hyperspace(s)
            for src, name, indexed, included in Q13_INDEXES[:2]:
                hs.create_index(s.read.parquet(os.path.join(base, "src", src)), hst.IndexConfig(name, indexed, included))
            for run in ("indexed", "disabled"):
                (hst.enable_hyperspace if run == "indexed" else hst.disable_hyperspace)(s)
                q13 = q13_query(lambda t: s.read.parquet(os.path.join(base, "src", t)), hst.col)
                if (scanned_indexes(q13) == ["custQ13", "ordQ13"]) != (run == "indexed"):
                    raise AssertionError(f"q13 {run}: the plan's indexes are wrong:\n{q13.explain_string()}")
                results[i][f"q13_{run}"] = q13.collect().to_numpy()
            root = os.path.join(wh, "indexes")
            files[i] = {
                os.path.relpath(os.path.join(d, f), root): hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
                for d, _, fs in os.walk(root) for f in fs if f.endswith(".parquet")
            }
        if files[0] != files[1]:
            raise AssertionError("index files built on the CPU and on the GPU differ")
        for name in results[0]:
            a, b = results[0][name], results[1][name]
            # Float sums may differ in rounding (rtol 1e-9); all else exactly.
            same = [np.allclose(a[k], b[k], rtol=1e-9, atol=0) if k == "revenue" else np.array_equal(a[k], b[k])
                    for k in a]
            if list(a) != list(b) or not all(same):
                raise AssertionError(f"{name}: CPU and GPU rows differ (values or order)")
        rows = {n: len(next(iter(r.values()))) for n, r in results[0].items()}
        log(f"[identity] SF{sf}: {len(files[0])} identical index files; rows identical in order "
            f"{json.dumps(rows)}")
    finally:
        shutil.rmtree(base, ignore_errors=True)


# ---------------------------------------------------------------------------
# The string slice: K3 builds, FilterIndexRule lookups with bucket pruning
# ---------------------------------------------------------------------------

STRING_INDEXES = [
    ("customer", "custSeg", ["c_mktsegment"], ["c_custkey", "c_name", "c_acctbal"]),
    ("lineitem", "liShip", ["l_shipmode"], ["l_orderkey", "l_quantity", "l_extendedprice"]),
]


def build_string_indexes(torch, base: str, device, warehouse: str):
    """The two string indexes; returns the session, build seconds and K3's
    launches per build."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.ops import cuda_comp_sort

    s = hst.HyperspaceSession(warehouse=warehouse, device=device)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    seconds, k3 = {}, {}
    for src, name, indexed, included in STRING_INDEXES:
        df = s.read.parquet(os.path.join(base, "src", src))
        before = cuda_comp_sort.launches
        _, seconds[name] = wall(lambda: hs.create_index(df, hst.IndexConfig(name, indexed, included)))
        k3[name] = cuda_comp_sort.launches - before
    hst.enable_hyperspace(s)
    return s, seconds, k3


def range_key(data) -> int:
    """q12_range's bound on l_orderkey: the 10th percentile of the column."""
    return int(np.percentile(data["lineitem"]["l_orderkey"], 10))


def string_queries(s, base: str, k: int):
    from hyperspace_tpu_torch import col

    def rd(name):
        return s.read.parquet(os.path.join(base, "src", name))

    cols = ("l_orderkey", "l_shipmode", "l_quantity", "l_extendedprice")
    return {
        "q3_filter": rd("customer").filter(col("c_mktsegment") == "BUILDING").select(
            "c_custkey", "c_name", "c_acctbal"
        ),
        "q12_filter": rd("lineitem").filter(col("l_shipmode").isin("MAIL", "SHIP")).select(*cols),
        "q12_range": rd("lineitem").filter(col("l_shipmode").isin("MAIL", "SHIP") & (col("l_orderkey") < k)).select(*cols),
    }


def expected_string_rows(data, k: int) -> dict:
    """The three lookups as numpy filters of the generated arrays."""
    cu, li = data["customer"], data["lineitem"]
    seg_dict, seg = cu["c_mktsegment"]
    keep = seg == int(np.searchsorted(seg_dict, "BUILDING"))
    q3 = {n: decoded(cu[n])[keep] for n in ("c_custkey", "c_name", "c_acctbal")}
    mode_dict, mode = li["l_shipmode"]
    keep = np.isin(mode, np.searchsorted(mode_dict, ["MAIL", "SHIP"]))
    cols = ("l_orderkey", "l_shipmode", "l_quantity", "l_extendedprice")
    q12 = {n: decoded(li[n])[keep] for n in cols}
    keep &= li["l_orderkey"] < k
    return {"q3_filter": q3, "q12_filter": q12, "q12_range": {n: decoded(li[n])[keep] for n in cols}}


def row_groups(df) -> dict:
    """Row groups an uncached run of a lookup decodes, of those in the files
    bucket pruning kept."""
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.physical import ExecContext, ScanExec

    clear_caches()
    plan = df.physical_plan()
    plan.execute(ExecContext(df.session))
    scan = next(n for n in plan.collect_nodes() if isinstance(n, ScanExec))
    total = sum(engine_io.footer_metadata(f.path).num_row_groups for f in scan.relation.files)
    return {"kept": total - scan.pruning.get("row_groups_skipped", 0), "total": total}


def index_scan(df):
    """The relation of the plan's one index scan (None when the rewrite did
    not fire)."""
    from hyperspace_tpu_torch.engine.physical import ScanExec

    rels = [n.relation for n in df.physical_plan().collect_nodes() if isinstance(n, ScanExec)]
    return rels[0] if len(rels) == 1 and rels[0].index_name else None


KEY_KIND_INDEXES = [
    ("customer", "custName", ["c_name"], ["c_custkey"]),
    ("customer_copy", "custName2", ["c2_name"], ["c2_custkey"]),
    ("orders_nullable", "ordNullCust", ["o_custkey_n"], ["o_orderkey"]),
    ("customer", "custKey", ["c_custkey"], ["c_acctbal"]),
]


def key_kind_sources(torch, data, base: str, seed: int) -> dict:
    """The key-kind cases' extra sources: a copy of customer with its columns
    renamed, and orders' o_custkey with 1% nulls drawn from its own
    `RandomState(seed + 1)` (so no other column moves). Returns the
    validity."""
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.table import Column, Table

    cu, od = data["customer"], data["orders"]
    copy = source_table({"c2_name": cu["c_name"], "c2_custkey": cu["c_custkey"]})
    engine_io.write_parquet(copy, os.path.join(base, "src", "customer_copy", "part-00000.parquet"))
    valid = np.random.RandomState(seed + 1).rand(len(od["o_custkey"])) >= 0.01
    nullable = Table({
        "o_orderkey": Column.from_values(od["o_orderkey"], "cpu"),
        "o_custkey_n": Column("int64", torch.from_numpy(np.where(valid, od["o_custkey"], 0)), None,
                              torch.from_numpy(valid)),
    })
    engine_io.write_parquet(nullable, os.path.join(base, "src", "orders_nullable", "part-00000.parquet"))
    return {"o_custkey_n": valid}


def key_kind_joins(torch, data, base: str, seed: int) -> dict:
    """Indexed joins on a string key (customer ⋈ its copy on the name) and on
    a nullable key (orders' nullable o_custkey ⋈ customer), both in hash
    mode (K1 then K2), each against numpy; returns their K1 and K2 launches
    and times."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch import col
    from hyperspace_tpu_torch.ops import cuda_probe, cuda_sort

    valid = key_kind_sources(torch, data, base, seed)["o_custkey_n"]
    s = hst.HyperspaceSession(warehouse=os.path.join(base, "keykinds"), device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    for src, name, indexed, included in KEY_KIND_INDEXES:
        hs.create_index(s.read.parquet(os.path.join(base, "src", src)), hst.IndexConfig(name, indexed, included))
    hst.enable_hyperspace(s)

    def rd(name):
        return s.read.parquet(os.path.join(base, "src", name))

    cu, od = data["customer"], data["orders"]
    qs = {
        "string_key": (rd("customer").join(rd("customer_copy"), col("c_name") == col("c2_name"))
                       .select("c_custkey", "c2_custkey"), ["custName", "custName2"],
                       {"c_custkey": cu["c_custkey"], "c2_custkey": cu["c_custkey"]}),
        "nullable_key": (rd("orders_nullable").join(rd("customer"), col("o_custkey_n") == col("c_custkey"))
                         .select("o_orderkey", "c_custkey"), ["custKey", "ordNullCust"],
                         {"o_orderkey": od["o_orderkey"][valid], "c_custkey": od["o_custkey"][valid]}),
    }
    out = {}
    for name, (df, indexes, rows) in qs.items():
        if scanned_indexes(df) != indexes:
            raise AssertionError(f"{name}: the plan does not scan {indexes}:\n{df.explain_string()}")
        k1, k2 = cuda_sort.launches, cuda_probe.launches
        clear_caches()
        got, t_cold = wall(df.collect)
        n = df.count()
        if n != len(rows["c_custkey"]) or not same_multiset(got.to_numpy(), canonical(rows)):
            raise AssertionError(f"{name}: {n} rows differ from numpy's {len(rows['c_custkey'])}")
        t = {"rows": n, "collect_cold_s": t_cold}
        _, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
        t.update(k1_launches=cuda_sort.launches - k1, k2_launches=cuda_probe.launches - k2)
        if not (t["k1_launches"] and t["k2_launches"]):
            raise AssertionError(f"{name}: the hash-mode join must launch K1 and K2: {t}")
        out[name] = t
        log(f"[strings] {name} {json.dumps(t)}")
    return out


def phase_strings(torch, data, base: str, seed: int):
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.ops import cuda_comp_sort, cuda_hash, cuda_probe, cuda_sort

    reset_launches(cuda_comp_sort)
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    s, build_s, k3 = build_string_indexes(torch, base, DEVICE, os.path.join(base, "strings"))
    log(f"[strings] build seconds {json.dumps(build_s)}; K3 launches per build {json.dumps(k3)}")
    if k3 != {"custSeg": 1, "liShip": 0}:
        raise AssertionError(f"K3 must sort the custSeg build and not the liShip build (int32 headroom): {k3}")
    k = range_key(data)
    want = {n: canonical(rows) for n, rows in expected_string_rows(data, k).items()}
    expect_idx = {"q3_filter": "custSeg", "q12_filter": "liShip", "q12_range": "liShip"}
    times = {}
    for name, df in string_queries(s, base, k).items():
        rel = index_scan(df)
        if rel is None or rel.index_name != expect_idx[name] or rel.pruned_by != ["FilterIndexRule:bucket"]:
            raise AssertionError(f"{name}: the plan does not scan the pruned index:\n{df.explain_string()}")

        def check(n, out):
            if n != len(next(iter(want[name].values()))) or not same_multiset(out.to_numpy(), want[name]):
                raise AssertionError(f"{name}: rows differ from the numpy filter (count {n})")

        clear_caches()
        n, t_count = wall(df.count)
        clear_caches()
        out, t_collect = wall(df.collect)
        check(n, out)
        t = {"rows": n, "files_scanned": len(rel.files), "count_cold_s": t_count, "collect_cold_s": t_collect}
        out, t["uncached_p50_s"] = run_p50(df.collect, 3, uncached=True)
        check(n, out)
        out, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
        n, t["count_cached_p50_s"] = run_p50(df.count, 3, uncached=False)
        check(n, out)
        t["row_groups"] = row_groups(df)
        if name == "q12_range":
            if t["row_groups"]["kept"] >= t["row_groups"]["total"]:
                raise AssertionError(f"q12_range: pushdown kept every row group {t['row_groups']}")
            os.environ["HYPERSPACE_SCAN_PUSHDOWN"] = "0"
            try:
                clear_caches()
                whole = df.collect().to_numpy()
            finally:
                del os.environ["HYPERSPACE_SCAN_PUSHDOWN"]
            got = out.to_numpy()
            if list(whole) != list(got) or not all(np.array_equal(whole[c], got[c]) for c in got):
                raise AssertionError("q12_range: rows differ from the read without pushdown")
        hst.disable_hyperspace(s)
        plain_df = string_queries(s, base, k)[name]
        if not same_multiset(plain_df.collect().to_numpy(), canonical(out.to_numpy())):
            raise AssertionError(f"{name}: indexed and non-indexed rows differ")
        hst.enable_hyperspace(s)
        times[name] = t
        log(f"[strings] {name} {json.dumps(t)}")
        clear_caches()
        log(f"[strings] {name} uncached collect breakdown {json.dumps(filter_breakdown(torch, df))}")
        log(f"[strings] {name} cached collect breakdown {json.dumps(filter_breakdown(torch, df))}")
    times.update(key_kind_joins(torch, data, base, seed))
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K3": cuda_comp_sort.launches,
                "K6": cuda_hash.launches}
    log(f"[strings] rows equal the numpy filters and the non-indexed queries, q12_range's the read without "
        f"pushdown, and the string-key and nullable-key joins numpy's; launches {json.dumps(launches)}")
    return launches, build_s, times


def filter_breakdown(torch, df) -> dict:
    """Seconds of each stage of one `collect()` of a filter query, run step
    by step with a synchronize after each, and the scan's parts."""
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.evaluate import evaluate_predicate
    from hyperspace_tpu_torch.engine.physical import ExecContext

    project = df.physical_plan()
    node = project
    while node.name != "Filter":
        node = node.children()[0]
    ctx = ExecContext(df.session)
    t = {}
    engine_io.reset_io_stats()
    table, t["scan_s"] = wall(lambda: node.child.execute(ctx))
    t["scan_split_s"] = engine_io.io_stats()["seconds"]
    keep, t["filter_eval_s"] = wall(lambda: torch.nonzero(evaluate_predicate(node.condition, table)).squeeze(1))
    out, t["gather_s"] = wall(lambda: table.take(keep).select(project.column_names))
    _, t["to_host_s"] = wall(lambda: out.to("cpu"))
    t["rows_scanned"] = table.num_rows
    return t


# ---------------------------------------------------------------------------
# Packed code reps: pad_buckets_by_codes (K4) and probe_code_ranges (K5)
# ---------------------------------------------------------------------------


def packed_inputs(torch, data, rng):
    """bench.py's packed shape, and lineitem's shipmode codes in the bucket
    layout of lineitem indexed by l_orderkey at 200 buckets."""
    from hyperspace_tpu_torch.engine.table import Column, Table
    from hyperspace_tpu_torch.ops.partition import bucketize_table

    card = 12
    lens = [rng.randint(0, 2 * 120_000 // 64, 64) for _ in range(2)]
    starts = [np.concatenate([[0], np.cumsum(x)]).astype(np.int64) for x in lens]
    bench = [(rng.randint(0, card, st[-1]).astype(np.int32), st) for st in starts]
    li = data["lineitem"]
    table = Table({
        "l_orderkey": Column.from_values(li["l_orderkey"], DEVICE),
        "l_shipmode": Column("string", torch.from_numpy(li["l_shipmode"][1]).to(DEVICE), li["l_shipmode"][0]),
    })
    out, st = bucketize_table(table, ["l_orderkey"], NUM_BUCKETS)
    ship = out.column("l_shipmode").data.cpu().numpy()
    return {
        "bench_64": (card, bench[0], bench[1]),
        "lineitem_shipmode_200": (len(SHIPMODES), (ship, st), (ship, st)),
    }


def phase_packed(torch, data, rng):
    from hyperspace_tpu_torch.ops import bucket_join, cuda_packed_probe, cuda_packed_sort

    inputs = packed_inputs(torch, data, rng)
    reset_launches(cuda_packed_sort)
    reset_launches(cuda_packed_probe)
    results = {}
    for name, (card, (l_codes, l_starts), (r_codes, r_starts)) in inputs.items():
        lc, rc = torch.from_numpy(l_codes).to(DEVICE), torch.from_numpy(r_codes).to(DEVICE)
        (lrep, rrep), t_pad = wall(lambda: (
            bucket_join.pad_buckets_by_codes(lc, l_starts, card), bucket_join.pad_buckets_by_codes(rc, r_starts, card)
        ))
        (lo, cnt), t_probe = wall(lambda: bucket_join.probe_code_ranges(lrep, rrep))
        plo, pcnt = cuda_packed_probe.probe_packed_plain(lrep.words, rrep.words, lrep.bits, lrep.lengths, rrep.lengths)
        if not (torch.equal(cnt, pcnt) and torch.equal(lo, plo)):
            raise AssertionError(f"{name}: K5 ranges differ from the plain probe")
        cnt_h = cnt.cpu().numpy()
        for b in range(len(l_starts) - 1):
            ls = np.sort(l_codes[l_starts[b]: l_starts[b + 1]])
            rs = np.sort(r_codes[r_starts[b]: r_starts[b + 1]])
            exp = np.searchsorted(rs, ls, "right") - np.searchsorted(rs, ls, "left")
            if not np.array_equal(cnt_h[b, : len(ls)], exp) or cnt_h[b, len(ls):].any():
                raise AssertionError(f"{name}: bucket {b} counts differ from numpy searchsorted")
        results[name] = {
            "buckets": len(l_starts) - 1, "cap": lrep.cap, "bits": lrep.bits, "rows": int(l_starts[-1]),
            "pad_sort_s": t_pad, "probe_s": t_probe, "pairs": int(cnt_h.sum(dtype=np.int64)),
        }
        log(f"[packed] {name} {json.dumps(results[name])}")
    launches = {"K4": cuda_packed_sort.launches, "K5": cuda_packed_probe.launches}
    if not launches["K4"] or not launches["K5"]:
        raise AssertionError(f"K4 and K5 must launch in the packed phase: {launches}")
    log(f"[packed] ranges equal the plain probe and numpy searchsorted; launches {json.dumps(launches)}")
    return launches, results


# ---------------------------------------------------------------------------
# Phase refresh: the index lifecycle over a changing lineitem
# ---------------------------------------------------------------------------

REFRESH_FILES = 8
#: The lineitem file written only at step (b). lineitem's rows come in
#: l_orderkey order, so the last file's keys lie above every indexed key and
#: an append of it keeps every bucket sorted (value mode); a middle file's
#: keys fall inside each bucket's range, which a two-version join must
#: handle in hash mode.
HELD_BACK = 3
REFRESH_INDEXES = [
    ("lineitem", "liR", ["l_orderkey"], ["l_extendedprice", "l_discount"]),
    ("orders", "ordR", ["o_orderkey"], ["o_custkey"]),
]


def refresh_bounds(data) -> np.ndarray:
    """Row bounds of the 8 lineitem source files (equal row ranges)."""
    return np.linspace(0, len(data["lineitem"]["l_orderkey"]), REFRESH_FILES + 1).astype(np.int64)


def lineitem_file(src: str, i: int) -> str:
    return os.path.join(src, "lineitem", f"part-{i:05d}.parquet")


def write_lineitem_file(data, src: str, bounds, i: int) -> None:
    from hyperspace_tpu_torch.engine import io as engine_io

    a, b = int(bounds[i]), int(bounds[i + 1])
    cols = {n: ((v[0], v[1][a:b]) if isinstance(v, tuple) else v[a:b]) for n, v in data["lineitem"].items()}
    engine_io.write_parquet(source_table(cols), lineitem_file(src, i))


def expected_q_ord(data, bounds, present) -> dict:
    """q_ord over the lineitem rows of the files in `present`, canonical."""
    li, od = data["lineitem"], data["orders"]
    rows = np.concatenate([np.arange(bounds[i], bounds[i + 1]) for i in sorted(present)])
    a, b = np_join(li["l_orderkey"][rows], od["o_orderkey"])
    return canonical({"l_extendedprice": li["l_extendedprice"][rows[a]], "o_custkey": od["o_custkey"][b]})


def join_mode(df) -> str:
    """"general", or the co-bucketed join's layout mode ("value" / "hash"),
    read from the join memos a collect of `df` filled."""
    from hyperspace_tpu_torch.engine.physical import ExecContext, SortMergeJoinExec

    join = next(n for n in df.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec))
    if not join.bucketed:
        return "general"
    left, right, ls, rs, subkey, rows_key = join._sides(ExecContext(df.session))
    return join._plan_and_ranges(left, right, ls, rs, subkey, rows_key)[0].mode


def index_files_per_side(df) -> dict:
    from hyperspace_tpu_torch.engine.physical import BucketedIndexScanExec, ScanExec

    return {
        n.relation.index_name: len(n.relation.files) for n in df.physical_plan().collect_nodes()
        if isinstance(n, (BucketedIndexScanExec, ScanExec)) and n.relation.index_name
    }


def version_dirs(entry) -> list:
    return sorted({p.split("v__=")[1].split(os.sep)[0] for p in entry.content.files()})


def measure_join(torch, phase: str, label: str, df, check, mode: str, files: dict) -> dict:
    """One step of a live-table phase: q_ord's count and collect, cold,
    uncached p50 of 3 and cached p50 of 3, each output checked (`check(out,
    n)`); the join must run in `mode` over `files` index files a side, with
    K1 in hash mode only and K2 in either co-bucketed mode. Logs the step
    and, for a co-bucketed join, an uncached collect's stage breakdown."""
    from hyperspace_tpu_torch.ops import cuda_probe, cuda_sort

    k1, k2 = cuda_sort.launches, cuda_probe.launches
    clear_caches()
    n, t_count = wall(df.count)
    clear_caches()
    out, t_cold = wall(df.collect)
    check(out, n)
    got_mode, got_files = join_mode(df), index_files_per_side(df)
    if got_mode != mode or got_files != files:
        raise AssertionError(f"{phase} {label}: join {got_mode} over {got_files}, want {mode} over {files}:\n"
                             f"{df.explain_string()}")
    t = {"rows": n, "mode": got_mode, "index_files": got_files, "count_cold_s": t_count, "collect_cold_s": t_cold}
    _, t["uncached_p50_s"] = run_p50(df.collect, 3, uncached=True)
    out, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
    check(out)
    t["k1_launches"], t["k2_launches"] = cuda_sort.launches - k1, cuda_probe.launches - k2
    if (mode == "hash" and not t["k1_launches"]) or (mode != "general" and not t["k2_launches"]):
        raise AssertionError(f"{phase} {label}: kernels not launched ({t})")
    if mode == "value" and t["k1_launches"]:
        raise AssertionError(f"{phase} {label}: K1 launched in value mode ({t})")
    log(f"[{phase}] {label} {json.dumps(t)}")
    if mode != "general":
        clear_caches()
        log(f"[{phase}] {label} uncached collect breakdown {json.dumps(stage_breakdown(torch, df))}")
    return t


def phase_refresh(torch, data, base: str):
    """Steps (a)-(f): fresh, appended and unrefreshed, incremental, deletes
    folded by auto, full, then delete / restore / cancel / vacuum; each
    step's join against numpy over the files that exist then."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.actions.refresh import RefreshIncrementalAction
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.index.builder import CoveringIndexBuilder
    from hyperspace_tpu_torch.index.data_manager import IndexDataManagerImpl
    from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort

    root = os.path.join(base, "refresh")
    src = os.path.join(root, "src")
    bounds = refresh_bounds(data)
    for i in range(REFRESH_FILES):
        if i != HELD_BACK:
            write_lineitem_file(data, src, bounds, i)
    engine_io.write_parquet(source_table(data["orders"]), os.path.join(src, "orders", "part-00000.parquet"))
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    s = hst.HyperspaceSession(warehouse=root, device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    s.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    hs = hst.Hyperspace(s)
    seconds = {}
    for table, name, indexed, included in REFRESH_INDEXES:
        df = s.read.parquet(os.path.join(src, table))
        _, seconds[f"create_{name}"] = wall(lambda: hs.create_index(df, hst.IndexConfig(name, indexed, included)))
    hst.enable_hyperspace(s)

    def query():
        rd = lambda t: s.read.parquet(os.path.join(src, t))  # noqa: E731
        return rd("lineitem").join(rd("orders"), hst.col("l_orderkey") == hst.col("o_orderkey")).select(
            "l_extendedprice", "o_custkey")

    def entry():
        return next(e for e in hs._manager.get_indexes() if e.name == "liR")

    def check(label, present, out, n=None):
        want = expected_q_ord(data, bounds, present)
        if n is not None and n != len(want["o_custkey"]):
            raise AssertionError(f"refresh {label}: count {n} != numpy join {len(want['o_custkey'])}")
        if not same_multiset(out.to_numpy(), want):
            raise AssertionError(f"refresh {label}: collected rows differ from the numpy join")

    steps = {}

    def measure(label, present, mode, files):
        steps[label] = measure_join(torch, "refresh", label, query(),
                                    lambda out, n=None: check(label, present, out, n), mode, files)

    present = set(range(REFRESH_FILES)) - {HELD_BACK}
    one_version = {"liR": NUM_BUCKETS, "ordR": NUM_BUCKETS}
    measure("a_fresh", present, "value", one_version)

    write_lineitem_file(data, src, bounds, HELD_BACK)
    present.add(HELD_BACK)
    measure("b_appended_unrefreshed", present, "general", {})

    s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    measure("b_h_hybrid", present, "hash", one_version)
    clear_caches()
    log(f"[refresh] b_h_hybrid merge split {json.dumps(merge_split(query()))}")
    hybrid_lookup(s, data, src, bounds, present, steps)
    held = os.path.join(root, "held")
    os.makedirs(held)
    os.rename(lineitem_file(src, 0), os.path.join(held, "part-00000.parquet"))  # keeps its mtime
    present.discard(0)
    measure("b_hd_hybrid_delete", present, "hash", one_version)
    clear_caches()
    log(f"[refresh] b_hd_hybrid_delete merge split {json.dumps(merge_split(query()))}")
    os.rename(os.path.join(held, "part-00000.parquet"), lineitem_file(src, 0))
    present.add(0)
    s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "false")

    _, seconds["incremental"] = wall(lambda: hs.refresh_index("liR", "incremental"))
    if version_dirs(entry()) != ["0", "1"]:
        raise AssertionError(f"refresh incremental: version directories {version_dirs(entry())}")
    measure("c_incremental", present, "hash", {"liR": 2 * NUM_BUCKETS, "ordR": NUM_BUCKETS})

    os.remove(lineitem_file(src, 0))
    present.discard(0)
    on_disk = sorted(os.listdir(os.path.join(root, "indexes", "liR")))
    _, seconds["deletes_only_auto"] = wall(lambda: hs.refresh_index("liR", "auto"))
    e = entry()
    if (e.deleted_source_files() != [lineitem_file(src, 0)] or version_dirs(e) != ["0", "1"]
            or sorted(os.listdir(os.path.join(root, "indexes", "liR"))) != on_disk):
        raise AssertionError(f"refresh auto: deletes {e.deleted_source_files()}, versions {version_dirs(e)}; "
                             "a deletes-only refresh must fold the delete and write no data")
    measure("d_deletes_folded", present, "hash", {"liR": 2 * NUM_BUCKETS, "ordR": NUM_BUCKETS})

    _, seconds["optimize"] = wall(lambda: hs.optimize_index("liR"))
    e = entry()
    names = [os.path.basename(p) for p in e.content.files()]
    if e.deleted_source_files() or version_dirs(e) != ["2"] or sorted(set(names)) != sorted(names) \
            or len(names) != NUM_BUCKETS:
        raise AssertionError(f"optimize: deletes {e.deleted_source_files()}, versions {version_dirs(e)}, "
                             f"{len(names)} files; want one file a bucket and no deletes")
    measure("d_o_optimized", present, "value", one_version)
    rebuilt = rebuild_shas(os.path.join(root, "rebuild"), src)
    if sorted(sha256(p) for p in e.content.files()) != rebuilt:
        raise AssertionError("optimize: the compacted files differ from a from-scratch create_index's")
    log(f"[refresh] d_o_optimized: {len(names)} compacted files sha256-identical to a rebuild's")

    _, seconds["full"] = wall(lambda: hs.refresh_index("liR", "full"))
    e = entry()
    if e.deleted_source_files() or version_dirs(e) != ["3"]:
        raise AssertionError(f"refresh full: deletes {e.deleted_source_files()}, versions {version_dirs(e)}")
    measure("e_full", present, "value", one_version)

    f = {}

    def uses_index(label, want_index):
        df = query()
        out, t = wall(df.collect)
        check(label, present, out)
        if ("liR" in index_files_per_side(df)) != want_index:
            raise AssertionError(f"refresh {label}: index used {not want_index}, want {want_index}")
        f[f"{label}_collect_s"] = t

    _, f["delete_s"] = wall(lambda: hs.delete_index("liR"))
    uses_index("deleted", False)
    _, f["restore_s"] = wall(lambda: hs.restore_index("liR"))
    uses_index("restored", True)
    index_path = os.path.join(root, "indexes", "liR")
    data_mgr = IndexDataManagerImpl(index_path)
    dead = RefreshIncrementalAction(CoveringIndexBuilder(s), IndexLogManagerImpl(index_path), index_path,
                                    data_mgr.get_path(data_mgr.get_latest_version_id() + 1))
    dead.begin()  # a refresh that died after begin(): its transient entry is the log's latest
    hs._manager.clear_cache()
    if IndexLogManagerImpl(index_path).get_latest_log().state != "REFRESHING" or entry().state != "ACTIVE":
        raise AssertionError("refresh: a dead writer's entry must read as the stable generation")
    uses_index("writer_in_flight", True)
    _, f["cancel_s"] = wall(lambda: hs.cancel("liR"))
    if IndexLogManagerImpl(index_path).get_latest_log().state != "ACTIVE":
        raise AssertionError("refresh: cancel must roll the dead refresh back to ACTIVE")
    uses_index("cancelled", True)
    hs.delete_index("liR")
    _, f["vacuum_s"] = wall(lambda: hs.vacuum_index("liR"))
    left = [n for n in os.listdir(index_path) if n.startswith("v__=")]
    names = hs.indexes().to_numpy()["name"].tolist()
    if left or "liR" in names or "ordR" not in names:
        raise AssertionError(f"refresh vacuum: version directories {left} left, indexes() {names}")
    uses_index("vacuumed", False)
    steps["f_lifecycle"] = f
    log(f"[refresh] f_lifecycle {json.dumps(f)}")
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    log(f"[refresh] seconds {json.dumps(seconds)}; every step equals numpy; launches {json.dumps(launches)}")
    return launches, seconds, steps


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def rebuild_shas(warehouse: str, src: str) -> list:
    """The sorted sha256 of liR's files built from scratch over the current
    source in another warehouse (the compaction oracle)."""
    import hyperspace_tpu_torch as hst

    s = hst.HyperspaceSession(warehouse=warehouse, device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    s.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    hs = hst.Hyperspace(s)
    table, name, indexed, included = REFRESH_INDEXES[0]
    hs.create_index(s.read.parquet(os.path.join(src, table)), hst.IndexConfig(name, indexed, included))
    e = next(e for e in hs._manager.get_indexes() if e.name == name)
    return sorted(sha256(p) for p in e.content.files())


def merge_split(df) -> dict:
    """Seconds of the parts of one Hybrid Scan merge of `df`'s stale side
    (the caller empties the caches), replayed step by step, each ended by a
    synchronize: the index files' scan, the appended files' decode, the
    bucketize's hash, sort and gather, the concatenation of the index rows
    with the bucketized ones, within it the union of each string column's
    dictionaries (host `np.unique`), and the interleaving gather. The replay
    must equal the scan's own merge."""
    import dataclasses

    import torch

    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.physical import BucketedIndexScanExec, ExecContext, interleave_perm
    from hyperspace_tpu_torch.ops.hashing import bucket_id
    from hyperspace_tpu_torch.ops.partition import _bucket_key_sort, bucket_starts

    scan = next(n for n in df.physical_plan().collect_nodes()
                if isinstance(n, BucketedIndexScanExec) and n.relation.hybrid_append is not None)
    spec = scan.relation.bucket_spec
    ctx = ExecContext(df.session)
    t = {}
    plain = BucketedIndexScanExec(dataclasses.replace(scan.relation, hybrid_append=None), scan.columns)
    (table, starts), t["index_scan_s"] = wall(lambda: plain._assemble(ctx))
    appended, t["appended_decode_s"] = wall(lambda: scan._appended_rows(ctx))
    cols = [appended.column(c) for c in spec.bucket_columns]
    b, t["bucketize_hash_s"] = wall(lambda: bucket_id(cols, spec.num_buckets))
    (perm, sorted_b, _), t["bucketize_sort_s"] = wall(lambda: _bucket_key_sort(b, cols, spec.num_buckets))
    (sorted_a, a_starts), t["bucketize_gather_s"] = wall(
        lambda: (appended.take(perm.long()), bucket_starts(sorted_b, spec.num_buckets)))
    strings = [n for n, c in table.columns.items() if c.is_string]
    pairs = [(table.column(n).dictionary, sorted_a.column(n).dictionary) for n in strings]
    _, t["dictionary_union_s"] = wall(lambda: [np.unique(np.concatenate(p)) for p in pairs])
    merged, t["concat_s"] = wall(lambda: engine_io.concat_tables([table, sorted_a]))
    out, t["interleave_s"] = wall(
        lambda: merged.take(interleave_perm(starts, a_starts, merged.num_rows, ctx.device)))
    own, own_starts = scan._merge_appended(ctx, table, starts)
    same = np.array_equal(own_starts, starts + a_starts) and all(
        torch.equal(own.column(n).data, out.column(n).data) for n in out.column_names)
    if not same:
        raise AssertionError("merge split: the replayed merge differs from the scan's own")
    t.update(index_rows=table.num_rows, appended_rows=appended.num_rows,
             dictionaries={n: [len(p[0]), len(p[1]), len(merged.column(n).dictionary)] for n, p in zip(strings, pairs)})
    return t


def hybrid_lookup(s, data, src: str, bounds, present, steps: dict) -> None:
    """Step (b-h)'s FilterIndexRule lookup: a key of the appended file 3,
    answered by the Union of liR's bucket-pruned index scan and file 3,
    against a numpy filter of the files present; cold, uncached p50 of 3 and
    cached p50 of 3."""
    import hyperspace_tpu_torch as hst

    key = int(data["lineitem"]["l_orderkey"][bounds[HELD_BACK]])
    cols = ["l_orderkey", "l_extendedprice", "l_discount"]
    df = s.read.parquet(os.path.join(src, "lineitem")).filter(hst.col("l_orderkey") == key).select(*cols)
    nodes = df.physical_plan().collect_nodes()
    if "Union" not in [n.name for n in nodes] or not any(
            getattr(getattr(n, "relation", None), "index_name", None) == "liR" for n in nodes):
        raise AssertionError(f"refresh b_h lookup: no Union over liR:\n{df.explain_string()}")
    li = data["lineitem"]
    rows = np.concatenate([np.arange(bounds[i], bounds[i + 1]) for i in sorted(present)])
    rows = rows[li["l_orderkey"][rows] == key]
    want = canonical({c: li[c][rows] for c in cols})

    def check(out):
        if not same_multiset(out.to_numpy(), want):
            raise AssertionError("refresh b_h lookup: rows differ from the numpy filter")

    clear_caches()
    out, t_cold = wall(df.collect)
    check(out)
    t = {"key": key, "rows": len(rows), "collect_cold_s": t_cold}
    _, t["uncached_p50_s"] = run_p50(df.collect, 3, uncached=True)
    out, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
    check(out)
    if df.count() != len(rows):
        raise AssertionError("refresh b_h lookup: count() differs from the numpy filter")
    steps["b_h_lookup"] = t
    log(f"[refresh] b_h_lookup {json.dumps(t)}")


# ---------------------------------------------------------------------------
# Phase skipping: a data-skipping index over TPC-DS store_sales (BASELINE config 4)
# ---------------------------------------------------------------------------

SS_ROWS = 2_880_404  # TPC-DS SF1 store_sales
SS_FIRST_DATE_SK = 2450816  # d_date_sk of 1998-01-02
SS_FIRST_DAY, SS_LAST_DAY = days("1998-01-02"), days("2002-12-31")
SS_FILES = 60  # one a month
SS_ROW_GROUP_ROWS = 8192
SS_TICKET_COLUMNS = ["ss_ticket_number", "ss_item_sk", "ss_net_paid"]


def date_sk(date: str) -> int:
    return SS_FIRST_DATE_SK + days(date) - SS_FIRST_DAY


def store_sales(rng, first_day: int, last_day: int, rows: int, ticket_base: int = 0):
    """`rows` store_sales rows of the days [first_day, last_day] in date
    order, and each row's month (0 = 1998-01). A ticket holds 8-16 rows (the
    last one the remainder) of one date, store and customer; its number is a
    random permutation over the tickets, unrelated to its date."""
    sizes = rng.randint(8, 17, rows // 8 + 1)
    n_t = int(np.searchsorted(np.cumsum(sizes), rows)) + 1
    sizes = sizes[:n_t]
    sizes[-1] -= int(sizes.sum()) - rows
    t_day = np.sort(rng.randint(first_day, last_day + 1, n_t))
    t_number = ticket_base + rng.permutation(n_t).astype(np.int64) + 1
    t_store = rng.randint(1, 13, n_t).astype(np.int64)
    t_cust = rng.randint(1, 100_001, n_t).astype(np.int64)
    day = np.repeat(t_day, sizes).astype(np.int64)
    quantity = rng.randint(1, 101, rows).astype(np.int64)
    price = rng.randint(100, 20_001, rows).astype(np.float64)  # cents
    discount = rng.randint(0, 31, rows)  # percent
    cols = {
        "ss_sold_date_sk": SS_FIRST_DATE_SK + day - SS_FIRST_DAY,
        "ss_ticket_number": np.repeat(t_number, sizes),
        "ss_item_sk": rng.randint(1, 18_001, rows).astype(np.int64),
        "ss_customer_sk": np.repeat(t_cust, sizes),
        "ss_store_sk": np.repeat(t_store, sizes),
        "ss_quantity": quantity,
        "ss_sales_price": price,
        "ss_net_paid": np.round(quantity * price * (100 - discount) / 100),
    }
    month = day.astype("datetime64[D]").astype("datetime64[M]").astype(np.int64)
    return cols, month - np.datetime64("1998-01", "M").astype(np.int64)


def skip_queries(hst, cols, rng) -> dict:
    """name → (build(df), row mask of the table's columns, result shape, files
    the indexed scan must keep: an int, or (at least, below) for a bloom)."""
    c = hst.col
    day, new_day = date_sk("2000-06-15"), date_sk("2003-01-15")
    lo, hi = date_sk("2001-07-01"), date_sk("2001-09-30")
    tickets = cols["ss_ticket_number"]
    one = int(tickets[len(tickets) // 3])
    some = sorted({int(t) for t in tickets[rng.choice(len(tickets), 20, replace=False)]})

    def by_store(df):
        return df.group_by("ss_store_sk").agg(net_paid=("ss_net_paid", "sum"), sales=("*", "count"))

    def ticket_rows(df):
        return df.select(*SS_TICKET_COLUMNS)

    d = "ss_sold_date_sk"
    return {
        "day": (lambda df: by_store(df.filter(c(d) == day)), lambda t: t[d] == day, "by_store", 1),
        "quarter": (lambda df: by_store(df.filter((c(d) >= lo) & (c(d) <= hi))),
                    lambda t: (t[d] >= lo) & (t[d] <= hi), "by_store", 3),
        "ticket": (lambda df: ticket_rows(df.filter(c("ss_ticket_number") == one)),
                   lambda t: t["ss_ticket_number"] == one, "rows", (1, SS_FILES)),
        "tickets_in_20": (lambda df: ticket_rows(df.filter(c("ss_ticket_number").isin(*some))),
                          lambda t: np.isin(t["ss_ticket_number"], some), "rows", (1, SS_FILES)),
        "absent_ticket": (lambda df: ticket_rows(df.filter(c("ss_ticket_number") == 0)),
                          lambda t: t["ss_ticket_number"] == 0, "rows", 0),
        "new_month_day": (lambda df: by_store(df.filter(c(d) == new_day)), lambda t: t[d] == new_day, "by_store",
                          None),
    }


def check_skip(label: str, out, want_cols: dict, shape: str) -> None:
    """`out` against numpy over the selected rows: a group-by on ss_store_sk
    (keys and counts exact, sums at rtol 1e-9) or the ticket rows as a
    multiset."""
    got = out.to_numpy()
    if shape == "rows":
        if not same_multiset(got, canonical({n: want_cols[n] for n in SS_TICKET_COLUMNS})):
            raise AssertionError(f"skipping {label}: rows differ from the numpy filter")
        return
    keys, inv = np.unique(want_cols["ss_store_sk"], return_inverse=True)
    order = np.argsort(got["ss_store_sk"], kind="stable")
    if not (np.array_equal(got["ss_store_sk"][order], keys)
            and np.array_equal(got["sales"][order], np.bincount(inv))
            and np.allclose(got["net_paid"][order], np.bincount(inv, weights=want_cols["ss_net_paid"]),
                            rtol=1e-9, atol=0)):
        raise AssertionError(f"skipping {label}: the group-by differs from numpy's")


def scan_relation(df):
    """The one source scan of `df`'s optimized plan (the rule runs here)."""
    from hyperspace_tpu_torch.engine.logical import ScanNode

    (scan,) = [n for n in df.optimized_plan().collect_nodes() if isinstance(n, ScanNode)]
    return scan.relation


def phase_skipping(torch, base: str, seed: int):
    """BASELINE config 4: a data-skipping index over store_sales.

    The table is TPC-DS SF1's store_sales row count (2,880,404) made with
    numpy from `seed`, written as 60 monthly files (1998-01 to 2002-12, a
    lake loaded once a month) of 8,192-row row groups, rows in date order.
    Simplifications of the TPC-DS generator: dates uniform over
    1998-01-02..2002-12-31 (no seasonal weights); tickets of 8-16 rows of one
    date, store and customer, numbered by a random permutation (so only a
    bloom finds a ticket's file); item, quantity, price (cents) and discount
    uniform and independent; net paid = quantity * price * (1 - discount),
    rounded to cents; the other 14 columns and every dimension table left
    out. ssSkip holds a row-group MinMax on ss_sold_date_sk and a bloom of
    65,536 bits and 5 hashes on ss_ticket_number. Each query runs indexed and
    disabled against numpy, then the mutations: a 61st month appended (no
    pruning without Hybrid Scan, the 60 sketched files pruned with it), an
    incremental refresh (all 61 sketched) and a file deleted with no lineage
    under Hybrid Scan (still pruning)."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.index.dataskipping import BloomFilterSketch, DataSkippingIndexConfig, MinMaxSketch
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort

    rng = np.random.RandomState(seed + 12)
    t0 = time.perf_counter()
    cols, month = store_sales(rng, SS_FIRST_DAY, SS_LAST_DAY, SS_ROWS)
    extra, _ = store_sales(rng, days("2003-01-01"), days("2003-01-31"), SS_ROWS // SS_FILES,
                           ticket_base=int(cols["ss_ticket_number"].max()))
    table = {n: np.concatenate([cols[n], extra[n]]) for n in cols}
    bounds = np.append(np.searchsorted(month, np.arange(SS_FILES + 1)), len(table["ss_store_sk"]))
    root = os.path.join(base, "skipping")
    src = os.path.join(root, "store_sales")

    def path(i):
        return os.path.join(src, f"part-{i:05d}.parquet")

    def write_month(i):
        engine_io.write_parquet(source_table({n: v[bounds[i]:bounds[i + 1]] for n, v in table.items()}), path(i),
                                SS_ROW_GROUP_ROWS)

    for i in range(SS_FILES):
        write_month(i)
    present = set(range(SS_FILES))
    log(f"[skipping] store_sales {SS_ROWS} rows in {SS_FILES} monthly files, "
        f"{len(np.unique(cols['ss_ticket_number']))} tickets (made and written in {time.perf_counter() - t0:.2f} s)")
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    s = hst.HyperspaceSession(warehouse=root, device=DEVICE)
    hs = hst.Hyperspace(s)
    config = DataSkippingIndexConfig("ssSkip", [MinMaxSketch("ss_sold_date_sk", "rowgroup"),
                                                BloomFilterSketch("ss_ticket_number", 65536, 5)])
    _, build_s = wall(lambda: hs.create_index(s.read.parquet(src), config))
    hst.enable_hyperspace(s)
    queries = skip_queries(hst, cols, rng)
    steps = {}

    def run(label, name, files=None, index=True):
        """One query: kept files, then cold, uncached p50 of 3 and cached p50
        of 3, each output and count() against numpy over the files present."""
        build, mask, shape, want_files = queries[name]
        rows = np.concatenate([np.arange(bounds[i], bounds[i + 1]) for i in sorted(present)])
        sel = rows[mask({n: v[rows] for n, v in table.items()})]
        want = {n: v[sel] for n, v in table.items()}
        df = build(s.read.parquet(src))
        rel, t_plan = wall(lambda: scan_relation(df))
        kept = len(rel.files)
        want_files = files if files is not None else want_files if index else len(present)
        ok = kept == want_files if isinstance(want_files, int) else want_files[0] <= kept < want_files[1]
        if not ok or (index and kept >= len(present) and files is None):
            raise AssertionError(f"skipping {label}: {kept} of {len(present)} files kept, want {want_files}:\n"
                                 f"{df.explain_string()}")
        clear_caches()
        out, t_cold = wall(df.collect)
        check_skip(label, out, want, shape)
        t = {"files_kept": kept, "files": len(present), "pruned_by": rel.pruned_by, "rows": len(sel),
             "plan_s": t_plan, "collect_cold_s": t_cold}
        _, t["uncached_p50_s"] = run_p50(df.collect, 3, uncached=True)
        out, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
        check_skip(label, out, want, shape)
        n = df.count()
        if n != out.num_rows:
            raise AssertionError(f"skipping {label}: count() {n} != {out.num_rows} rows")
        t.update(device_busy(df))
        steps[label] = t
        log(f"[skipping] {label} {json.dumps(t)}")

    first = queries["day"][0](s.read.parquet(src))
    _, rule_cold = wall(lambda: scan_relation(first))  # reads the sketch file
    _, rule_warm = wall(lambda: scan_relation(first))
    log(f"[skipping] sketch build {build_s:.4f} s; rule cold {rule_cold:.4f} s, warm {rule_warm:.4f} s")
    names = [n for n in queries if n != "new_month_day"]
    for name in names:
        run(f"{name}_indexed", name)
    hst.disable_hyperspace(s)
    for name in names:
        run(f"{name}_disabled", name, index=False)
    hst.enable_hyperspace(s)

    write_month(SS_FILES)
    present.add(SS_FILES)
    run("m1_appended_no_hybrid_day", "day", files=SS_FILES + 1)
    s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    run("m1_appended_hybrid_day", "day", files=2)
    run("m1_appended_hybrid_new_month_day", "new_month_day", files=1)
    s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "false")
    _, refresh_s = wall(lambda: hs.refresh_index("ssSkip", "incremental"))
    run("m2_incremental_day", "day", files=1)
    run("m2_incremental_new_month_day", "new_month_day", files=1)
    august = (2001 - 1998) * 12 + 7  # 2001-08, inside the quarter
    os.remove(path(august))
    present.discard(august)
    s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    run("m3_deleted_hybrid_quarter", "quarter", files=2)
    run("m3_deleted_hybrid_day", "day", files=1)
    seconds = {"sketch_build_s": build_s, "rule_cold_s": rule_cold, "rule_warm_s": rule_warm,
               "incremental_refresh_s": refresh_s}
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    log(f"[skipping] seconds {json.dumps(seconds)}; every query equals numpy; launches {json.dumps(launches)}")
    return launches, seconds, steps


# ---------------------------------------------------------------------------
# Phase delta: the live-table steps over a Delta table (BASELINE config 5)
# ---------------------------------------------------------------------------


def lineitem_table(data, rows):
    """A host table of lineitem's rows `rows` (an index array)."""
    return source_table({n: ((v[0], v[1][rows]) if isinstance(v, tuple) else v[rows])
                         for n, v in data["lineitem"].items()})


def phase_delta(torch, data, base: str):
    """Steps (a)-(g) over lineitem as a Delta table of 8 commits (file 3
    held back, as phase refresh splits it); orders as one parquet file; each
    step's join against numpy over the snapshot's rows."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.logical import ScanNode
    from hyperspace_tpu_torch.index.dataskipping import DataSkippingIndexConfig, MinMaxSketch
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort
    from hyperspace_tpu_torch.storage import delta as delta_log

    root = os.path.join(base, "delta")
    table, orders = os.path.join(root, "lineitem"), os.path.join(root, "orders")
    bounds = refresh_bounds(data)
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    s = hst.HyperspaceSession(warehouse=root, device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    s.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    commit_file = {}

    def commit(i):
        before = {f.path for f in delta_log.active_files(table)} if delta_log.is_delta_table(table) else set()
        s.write_delta(lineitem_table(data, np.arange(bounds[i], bounds[i + 1])), table)
        (commit_file[i],) = {f.path for f in delta_log.active_files(table)} - before

    t0 = time.perf_counter()
    for i in range(REFRESH_FILES):
        if i != HELD_BACK:
            commit(i)
    engine_io.write_parquet(source_table(data["orders"]), os.path.join(orders, "part-00000.parquet"))
    log(f"[delta] lineitem as {REFRESH_FILES - 1} commits, orders as one file "
        f"(written in {time.perf_counter() - t0:.2f} s)")
    hs = hst.Hyperspace(s)
    seconds = {}
    _, seconds["create_liD"] = wall(lambda: hs.create_index(
        s.read.delta(table), hst.IndexConfig("liD", ["l_orderkey"], ["l_extendedprice", "l_discount"])))
    _, seconds["create_ordD"] = wall(lambda: hs.create_index(
        s.read.parquet(orders), hst.IndexConfig("ordD", ["o_orderkey"], ["o_custkey"])))
    hst.enable_hyperspace(s)

    def query():
        return s.read.delta(table).join(s.read.parquet(orders), hst.col("l_orderkey") == hst.col("o_orderkey")).select(
            "l_extendedprice", "o_custkey")

    def entry(name="liD"):
        return next(e for e in hs._manager.get_indexes() if e.name == name)

    steps = {}
    present = set(range(REFRESH_FILES)) - {HELD_BACK}

    def measure(label, mode, files):
        want = expected_q_ord(data, bounds, present)

        def check(out, n=None):
            if n is not None and n != len(want["o_custkey"]):
                raise AssertionError(f"delta {label}: count {n} != numpy join {len(want['o_custkey'])}")
            if not same_multiset(out.to_numpy(), want):
                raise AssertionError(f"delta {label}: collected rows differ from the numpy join")

        steps[label] = measure_join(torch, "delta", label, query(), check, mode, files)

    one_version = {"liD": NUM_BUCKETS, "ordD": NUM_BUCKETS}
    measure("a_fresh", "value", one_version)
    commit(HELD_BACK)
    present.add(HELD_BACK)
    measure("b_appended_unrefreshed", "general", {})
    s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    measure("b_h_hybrid", "hash", one_version)
    s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "false")
    _, seconds["incremental"] = wall(lambda: hs.refresh_index("liD", "incremental"))
    if version_dirs(entry()) != ["0", "1"]:
        raise AssertionError(f"delta incremental: version directories {version_dirs(entry())}")
    measure("c_incremental", "hash", {"liD": 2 * NUM_BUCKETS, "ordD": NUM_BUCKETS})

    delta_log.remove_file(table, os.path.relpath(commit_file[0], table))
    present.discard(0)
    if not os.path.exists(commit_file[0]) or commit_file[0] in [f.path for f in delta_log.active_files(table)]:
        raise AssertionError("delta remove: the file must stay on disk and leave the snapshot")
    _, seconds["removed_auto"] = wall(lambda: hs.refresh_index("liD", "auto"))
    if entry().deleted_source_files() != [commit_file[0]]:
        raise AssertionError(f"delta auto: deletedSourceFiles {entry().deleted_source_files()}, want file 0")
    measure("d_removed_auto", "hash", {"liD": 2 * NUM_BUCKETS, "ordD": NUM_BUCKETS})

    _, seconds["optimize"] = wall(lambda: hs.optimize_index("liD"))
    e = entry()
    if e.deleted_source_files() or len(e.content.files()) != NUM_BUCKETS:
        raise AssertionError(f"delta optimize: deletes {e.deleted_source_files()}, {len(e.content.files())} files")
    r = hst.HyperspaceSession(warehouse=os.path.join(root, "rebuild"), device=DEVICE)
    r.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    r.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    rh = hst.Hyperspace(r)
    rh.create_index(r.read.delta(table), hst.IndexConfig("liD", ["l_orderkey"], ["l_extendedprice", "l_discount"]))
    rebuilt = sorted(sha256(p) for p in next(x for x in rh._manager.get_indexes() if x.name == "liD").content.files())
    if sorted(sha256(p) for p in e.content.files()) != rebuilt:
        raise AssertionError("delta optimize: the compacted files differ from a from-scratch create_index's")
    log(f"[delta] e_optimized: {NUM_BUCKETS} compacted files sha256-identical to a rebuild's")
    measure("e_optimized", "value", one_version)

    _, seconds["create_liSkipD"] = wall(lambda: hs.create_index(
        s.read.delta(table), DataSkippingIndexConfig("liSkipD", [MinMaxSketch("l_orderkey")])))
    keys = data["lineitem"]["l_orderkey"]
    for label, i in (("f_skip_inside_file_5", 5), ("f_skip_inside_removed_file_0", 0)):
        a, b = int(bounds[i]), int(bounds[i + 1])
        lo, hi = int(keys[a + (b - a) // 3]), int(keys[a + (b - a) // 2])
        df = s.read.delta(table).filter((hst.col("l_orderkey") >= lo) & (hst.col("l_orderkey") <= hi)).select(
            "l_orderkey", "l_partkey")
        (scan,) = [n for n in df.optimized_plan().collect_nodes() if isinstance(n, ScanNode)]
        kept = [f.path for f in scan.relation.files]
        want_kept = [commit_file[i]] if i in present else []
        if kept != want_kept or commit_file[0] in kept:
            raise AssertionError(f"delta {label}: kept {kept}, want {want_kept}")
        rows = np.concatenate([np.arange(bounds[j], bounds[j + 1]) for j in sorted(present)])
        rows = rows[(keys[rows] >= lo) & (keys[rows] <= hi)]
        want = canonical({"l_orderkey": keys[rows], "l_partkey": data["lineitem"]["l_partkey"][rows]})
        clear_caches()
        out, t_cold = wall(df.collect)
        if not same_multiset(out.to_numpy(), want) or df.count() != len(rows):
            raise AssertionError(f"delta {label}: rows differ from the numpy filter")
        t = {"files_kept": len(kept), "rows": len(rows), "collect_cold_s": t_cold}
        _, t["uncached_p50_s"] = run_p50(df.collect, 3, uncached=True)
        out, t["cached_p50_s"] = run_p50(df.collect, 3, uncached=False)
        if not same_multiset(out.to_numpy(), want):
            raise AssertionError(f"delta {label}: cached rows differ from the numpy filter")
        steps[label] = t
        log(f"[delta] {label} {json.dumps(t)}")

    rows = np.concatenate([np.arange(bounds[j], bounds[j + 1]) for j in sorted(present)])
    s.write_delta(lineitem_table(data, rows), table, "overwrite")
    _, seconds["overwrite_full"] = wall(lambda: hs.refresh_index("liD", "full"))
    if len(entry().content.files()) != NUM_BUCKETS or len(delta_log.active_files(table)) != 1:
        raise AssertionError("delta full: want one version of the index over the one overwritten file")
    measure("g_overwrite_full", "value", one_version)
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    log(f"[delta] seconds {json.dumps(seconds)}; every step equals numpy; launches {json.dumps(launches)}")
    return launches, seconds, steps


# ---------------------------------------------------------------------------
# Phase partitioned: TPC-DS Q3 over a date-partitioned store_sales
# ---------------------------------------------------------------------------

ITEM_ROWS = 18_000  # TPC-DS SF1 item
DD_ROWS = 73_049  # TPC-DS date_dim
DD_FIRST_SK, DD_FIRST_DATE = 2415022, "1900-01-02"
NULL_DATE_SHARE = 0.01  # tickets with no sale date (this phase's choice, not TPC-DS's rate)
PART_COLUMN = "ss_sold_date_sk"
HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"
DS_Q3_COLUMNS = ["d_year", "i_brand_id", "i_brand", "sum_agg"]
DS_INDEXES = [
    # The JoinIndexRule counts only configured columns as covered (the JAX
    # package's rules/join_index_rule.py:115), so Q3's join key to date_dim
    # is configured; lineage would pull it in anyway.
    ("store_sales", "ssItem", ["ss_item_sk"], ["ss_net_paid", PART_COLUMN]),
    ("item", "itemIdx", ["i_item_sk"], ["i_brand_id", "i_brand", "i_manufact_id"]),
]


def tpcds_tables(rng, ss_rows: int, first_day: int, last_day: int, items: int = ITEM_ROWS,
                 null_share: float = NULL_DATE_SHARE) -> dict:
    """store_sales (the `store_sales` generator's rows of the days, a
    `null_share` of tickets with a null sale date: `valid` False), item
    (`items` rows, manufacturer and brand ids uniform over 1..1000, the brand
    named by its id) and date_dim (`date_dim_table`)."""
    cols, _ = store_sales(rng, first_day, last_day, ss_rows)
    cols["ss_item_sk"] = rng.randint(1, items + 1, ss_rows).astype(np.int64)
    tickets = np.unique(cols["ss_ticket_number"])
    dropped = tickets[rng.rand(len(tickets)) < null_share]
    cols["valid"] = ~np.isin(cols["ss_ticket_number"], dropped)
    brand_id = rng.randint(1, 1001, items).astype(np.int64)
    item = {"i_item_sk": np.arange(1, items + 1, dtype=np.int64), "i_brand_id": brand_id,
            "i_brand": np.array([f"brand #{b}" for b in brand_id]),
            "i_manufact_id": rng.randint(1, 1001, items).astype(np.int64)}
    return {"store_sales": cols, "item": item, "date_dim": date_dim_table()}


def date_dim_table() -> dict:
    """TPC-DS's date_dim: 73,049 days from 1900-01-02, the date an ISO
    string, and d_month_seq counting months from 1900-01 (2000-01 is 1200)."""
    dates = np.datetime64(DD_FIRST_DATE) + np.arange(DD_ROWS)
    year = dates.astype("datetime64[Y]").astype(np.int64) + 1970
    moy = dates.astype("datetime64[M]").astype(np.int64) % 12 + 1
    return {"d_date_sk": DD_FIRST_SK + np.arange(DD_ROWS, dtype=np.int64), "d_date": dates.astype(str),
            "d_year": year, "d_moy": moy, "d_month_seq": (year - 1900) * 12 + moy - 1}


def partition_dirs(cols: dict) -> list:
    """(partition directory name, row indices) of store_sales by sale date,
    the null dates last."""
    null = np.iinfo(np.int64).max
    key = np.where(cols["valid"], cols[PART_COLUMN], null)
    order = np.argsort(key, kind="stable")
    values, starts = np.unique(key[order], return_index=True)
    ends = np.append(starts[1:], len(order))
    return [(f"{PART_COLUMN}={HIVE_NULL if v == null else int(v)}", order[a:b])
            for v, a, b in zip(values, starts, ends)]


def write_store_sales_partitioned(cols: dict, root: str, dirs=None) -> int:
    """One `part-00000.parquet` a day under `root/ss_sold_date_sk=<sk>/`,
    without the partition column; the files written."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    names = [n for n in cols if n not in (PART_COLUMN, "valid")]
    dirs = partition_dirs(cols) if dirs is None else dirs
    for d, rows in dirs:
        os.makedirs(os.path.join(root, d), exist_ok=True)
        pq.write_table(pa.table({n: cols[n][rows] for n in names}), os.path.join(root, d, "part-00000.parquet"))
    return len(dirs)


def ds_q3_query(read, col, n: int = 100):
    """TPC-DS Q3 through either package's DataFrame API (`read(table)`):
    store_sales ⋈ item (manufacturer 128) ⋈ date_dim (November) on the sale
    date, the sales summed by year and brand, ORDER BY d_year, the sum
    descending and the brand id, LIMIT n. ss_net_paid stands in for
    ss_ext_sales_price, which the generator does not make."""
    ss, item = read("store_sales"), read("item").filter(col("i_manufact_id") == 128)
    dd = read("date_dim").filter(col("d_moy") == 11)
    return (
        ss.join(item, col("ss_item_sk") == col("i_item_sk"))
        .join(dd, col(PART_COLUMN) == col("d_date_sk"))
        .group_by("d_year", "i_brand", "i_brand_id")
        .agg(sum_agg=("ss_net_paid", "sum"))
        .order_by("d_year", ("sum_agg", False), "i_brand_id")
        .limit(n)
        .select(*DS_Q3_COLUMNS)
    )


def expected_ds_q3(tables: dict, rows=None) -> dict:
    """Q3 of the generated arrays with numpy, every group in Q3's order;
    `rows` restricts store_sales to the rows present (all by default)."""
    ss, item, dd = tables["store_sales"], tables["item"], tables["date_dim"]
    rows = np.arange(len(ss["valid"])) if rows is None else rows
    rows = rows[ss["valid"][rows]]
    it = ss["ss_item_sk"][rows] - 1
    day = ss[PART_COLUMN][rows] - DD_FIRST_SK
    keep = (item["i_manufact_id"][it] == 128) & (dd["d_moy"][day] == 11)
    year, brand = dd["d_year"][day[keep]], item["i_brand_id"][it[keep]]
    keys, inv = np.unique(np.stack([year, brand]), axis=1, return_inverse=True)
    total = np.bincount(inv.reshape(-1), weights=ss["ss_net_paid"][rows][keep], minlength=keys.shape[1])
    by = np.lexsort((keys[1], -total, keys[0]))
    return {"d_year": keys[0][by], "i_brand_id": keys[1][by],
            "i_brand": np.array([f"brand #{b}" for b in keys[1][by]]), "sum_agg": total[by]}


def check_ds_q3(label: str, got: dict, want: dict, n: int = 100) -> None:
    """`got` must be numpy's first n rows in order, sums at rtol 1e-9; rows
    whose sums tie within the tolerance in one year may swap places."""
    m = min(n, len(want["d_year"]))
    if list(got) != DS_Q3_COLUMNS or len(got["d_year"]) != m:
        raise AssertionError(f"{label}: columns {list(got)} and {len(got['d_year'])} rows, want {DS_Q3_COLUMNS}, {m}")
    total, year = want["sum_agg"], want["d_year"]
    tie = np.isclose(total[1:], total[:-1], rtol=1e-9, atol=0) & (year[1:] == year[:-1])
    cls = np.concatenate([[0], np.cumsum(~tie)])
    key = np.asarray(got["d_year"]).astype(np.int64) * 10_000 + np.asarray(got["i_brand_id"]).astype(np.int64)
    wkey = year * 10_000 + want["i_brand_id"]
    for c in np.unique(cls[:m]):
        pos, members = np.nonzero(cls[:m] == c)[0], np.nonzero(cls == c)[0]
        have, allowed = set(key[pos].tolist()), set(wkey[members].tolist())
        if not (have <= allowed if members[-1] >= m else have == allowed):
            raise AssertionError(f"{label}: rows {pos.tolist()} hold groups {sorted(have)}, numpy {sorted(allowed)}")
    at = {k: i for i, k in enumerate(wkey.tolist())}
    idx = np.array([at[k] for k in key.tolist()], np.int64)
    if list(got["i_brand"]) != list(want["i_brand"][idx]):
        raise AssertionError(f"{label}: i_brand differs from numpy's Q3")
    if not np.allclose(np.asarray(got["sum_agg"], np.float64), total[idx], rtol=1e-9, atol=0):
        raise AssertionError(f"{label}: sum_agg differs from numpy's Q3 beyond rtol 1e-9")


def index_shas(hs, name: str) -> list:
    return sorted(sha256(p) for p in next(e for e in hs._manager.get_indexes() if e.name == name).content.files())


def phase_partitioned(torch, base: str, seed: int):
    """TPC-DS SF1's store_sales (2,880,404 rows, the `store_sales`
    generator's simplifications) partitioned by ss_sold_date_sk, one file a
    day (1,825 days, 1998-01-02..2002-12-31) and one for the null dates (1%
    of tickets); item (18,000 rows) as ORC, date_dim (73,049 rows) as CSV,
    all made with numpy from `seed`. Steps, each against numpy: (a) the read
    (schema, count, one day, is_null); (b) ssItem and itemIdx built with
    lineage on; (c) TPC-DS Q3 indexed (the co-bucketed store_sales ⋈ item,
    then the general join to date_dim on the partition column) and disabled,
    cold, uncached p50 of 3, cached p50 of 3 and an uncached run by stage;
    (d) a day appended: Q3 under Hybrid Scan, then after an incremental
    refresh, then `optimize_index`, equal to a rebuild's sha256 set; (e) a
    MinMax sketch on the partition column and a month's filter, indexed and
    disabled; (f) item again as JSON lines, its covering index's lookup
    against the ORC index's and numpy."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.physical import SortMergeJoinExec
    from hyperspace_tpu_torch.index.dataskipping import DataSkippingIndexConfig, MinMaxSketch
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort
    from hyperspace_tpu_torch.telemetry.profiling import last_build_stages

    try:
        import pyarrow.orc  # noqa: F401

        item_format = "orc"
    except ImportError:
        item_format = "parquet"
    rng = np.random.RandomState(seed + 13)
    phase_t0 = time.perf_counter()
    root = os.path.join(base, "partitioned")
    src = {t: os.path.join(root, t) for t in ("store_sales", "item", "date_dim", "item_json")}
    seconds = {}
    t0 = time.perf_counter()
    tables = tpcds_tables(rng, SS_ROWS, SS_FIRST_DAY, SS_LAST_DAY)
    ss = tables["store_sales"]
    seconds["generate"] = time.perf_counter() - t0
    s = hst.HyperspaceSession(warehouse=root, device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    s.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    t0 = time.perf_counter()
    n_files = write_store_sales_partitioned(ss, src["store_sales"])
    getattr(s, f"write_{item_format}")(tables["item"], src["item"])
    s.write_csv(tables["date_dim"], src["date_dim"])
    seconds["write"] = time.perf_counter() - t0
    log(f"[partitioned] store_sales {SS_ROWS} rows in {n_files} day files ({int((~ss['valid']).sum())} rows "
        f"null-dated), item {ITEM_ROWS} rows as {item_format}, date_dim {DD_ROWS} rows as csv "
        f"(made in {seconds['generate']:.2f} s, written in {seconds['write']:.2f} s)")
    readers = {"store_sales": s.read.parquet, "item": getattr(s.read, item_format), "date_dim": s.read.csv,
               "item_json": s.read.json}

    def read(t):
        return readers[t](src[t])

    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)

    # (a) the read
    c = hst.col
    df, seconds["a_read_plan"] = wall(lambda: read("store_sales"))
    names = [f.name for f in df.schema.fields]
    want_names = [n for n in ss if n not in (PART_COLUMN, "valid")] + [PART_COLUMN]
    if names != want_names or df.schema.field(PART_COLUMN).dtype != "int64":
        raise AssertionError(f"partitioned (a): schema {df.schema}, want {want_names} with {PART_COLUMN} int64")
    day = date_sk("2000-06-15")
    checks = {"count": (df, SS_ROWS),
              "one_day": (df.filter(c(PART_COLUMN) == day), int((ss["valid"] & (ss[PART_COLUMN] == day)).sum())),
              "null_date": (df.filter(c(PART_COLUMN).is_null()), int((~ss["valid"]).sum()))}
    for label, (q, want) in checks.items():
        clear_caches()
        got, seconds[f"a_{label}_cold"] = wall(q.count)
        if got != want:
            raise AssertionError(f"partitioned (a) {label}: count {got}, numpy {want}")
    clear_caches()
    day_rows, seconds["a_one_day_collect_cold"] = wall(checks["one_day"][0].select("ss_ticket_number", PART_COLUMN).collect)
    sel = ss["valid"] & (ss[PART_COLUMN] == day)
    if not same_multiset(day_rows.to_numpy(), canonical({"ss_ticket_number": ss["ss_ticket_number"][sel],
                                                         PART_COLUMN: ss[PART_COLUMN][sel]})):
        raise AssertionError("partitioned (a): the day's rows differ from numpy's")
    log(f"[partitioned] (a) schema {names}; count, one day and is_null equal numpy")

    # (b) the builds
    hs = hst.Hyperspace(s)
    engine_io.reset_io_stats()
    for table, name, indexed, included in DS_INDEXES:
        _, seconds[f"b_create_{name}"] = wall(lambda: hs.create_index(read(table), hst.IndexConfig(name, indexed, included)))
        log(f"[partitioned] (b) {name} build stages {json.dumps(last_build_stages())}")
    log(f"[partitioned] (b) builds {json.dumps({k: v for k, v in seconds.items() if k.startswith('b_')})}; "
        f"scan parts {json.dumps(engine_io.io_stats()['seconds'])}")
    hst.enable_hyperspace(s)

    # (c) TPC-DS Q3
    want = expected_ds_q3(tables)
    q3 = ds_q3_query(read, c)
    results, steps = {}, {}

    def measure(label, expect_joins, want_q3, indexes=None):
        joins = [n for n in q3.physical_plan().collect_nodes() if isinstance(n, SortMergeJoinExec)]
        kinds = sorted("bucketed" if j.bucketed else "general" for j in joins)
        if kinds != expect_joins or (indexes is not None and scanned_indexes(q3) != indexes):
            raise AssertionError(f"partitioned {label}: joins {kinds}, want {expect_joins}:\n{q3.explain_string()}")
        k1, k2 = cuda_sort.launches, cuda_probe.launches
        clear_caches()
        out, t_cold = wall(q3.collect)
        check_ds_q3(f"partitioned {label}", out.to_numpy(), want_q3)
        t = {"rows": out.num_rows, "collect_cold_s": t_cold}
        out, t["uncached_p50_s"] = run_p50(q3.collect, 3, uncached=True)
        check_ds_q3(f"partitioned {label}", out.to_numpy(), want_q3)
        out, t["cached_p50_s"] = run_p50(q3.collect, 3, uncached=False)
        check_ds_q3(f"partitioned {label}", out.to_numpy(), want_q3)
        if q3.count() != out.num_rows:
            raise AssertionError(f"partitioned {label}: count() {q3.count()} != {out.num_rows} rows")
        t["k1_launches"], t["k2_launches"] = cuda_sort.launches - k1, cuda_probe.launches - k2
        if "bucketed" in kinds and not t["k2_launches"]:
            raise AssertionError(f"partitioned {label}: K2 never launched ({t})")
        t.update(device_busy(q3))
        steps[label] = t
        results[label] = out.to_numpy()
        log(f"[partitioned] {label} {json.dumps(t)}")
        engine_io.reset_io_stats()
        stages = query_stage_split(torch, q3, True)
        log(f"[partitioned] {label} uncached collect stages {json.dumps(stages)}; its scans' parts "
            f"{json.dumps(engine_io.io_stats()['seconds'])}")

    measure("c_q3_indexed", ["bucketed", "general"], want, ["itemIdx", "ssItem"])
    hst.disable_hyperspace(s)
    measure("c_q3_disabled", ["general", "general"], want)
    hst.enable_hyperspace(s)
    a, b = results["c_q3_indexed"], results["c_q3_disabled"]
    if not all(np.array_equal(a[k], b[k]) for k in ("d_year", "i_brand_id", "i_brand")) or not np.allclose(
            a["sum_agg"], b["sum_agg"], rtol=1e-9, atol=0):
        raise AssertionError("partitioned (c): the indexed and the disabled Q3 differ")
    top = {k: (v[:5].tolist() if k != "sum_agg" else [round(float(x), 2) for x in v[:5]]) for k, v in a.items()}
    log(f"[partitioned] (c) Q3 {len(a['d_year'])} rows, indexed = disabled = numpy; first rows {json.dumps(top)}")

    # (d) one more day
    new_day = date_sk("2003-01-01")
    extra, _ = store_sales(rng, days("2003-01-01"), days("2003-01-01"), SS_ROWS // (SS_LAST_DAY - SS_FIRST_DAY + 1),
                           ticket_base=int(ss["ss_ticket_number"].max()))
    extra["ss_item_sk"] = rng.randint(1, ITEM_ROWS + 1, len(extra["ss_item_sk"])).astype(np.int64)
    extra["valid"] = np.ones(len(extra["ss_item_sk"]), bool)
    write_store_sales_partitioned(extra, src["store_sales"])
    if not os.path.isdir(os.path.join(src["store_sales"], f"{PART_COLUMN}={new_day}")):
        raise AssertionError("partitioned (d): the new day's directory was not written")
    tables["store_sales"] = ss = {n: np.concatenate([ss[n], extra[n]]) for n in ss}
    want = expected_ds_q3(tables)
    q3 = ds_q3_query(read, c)  # a new read lists the new day
    s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    if "(+1 appended)" not in q3.explain_string():
        raise AssertionError(f"partitioned (d): no Hybrid Scan over the new day:\n{q3.explain_string()}")
    measure("d_hybrid", ["bucketed", "general"], want, ["itemIdx", "ssItem"])
    s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "false")
    _, seconds["d_incremental"] = wall(lambda: hs.refresh_index("ssItem", "incremental"))
    measure("d_incremental", ["bucketed", "general"], want, ["itemIdx", "ssItem"])
    _, seconds["d_optimize"] = wall(lambda: hs.optimize_index("ssItem"))
    r = hst.HyperspaceSession(warehouse=os.path.join(root, "rebuild"), device=DEVICE)
    r.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    r.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    rh = hst.Hyperspace(r)
    table, name, indexed, included = DS_INDEXES[0]
    _, seconds["d_rebuild"] = wall(lambda: rh.create_index(r.read.parquet(src[table]),
                                                           hst.IndexConfig(name, indexed, included)))
    if index_shas(hs, "ssItem") != index_shas(rh, "ssItem"):
        raise AssertionError("partitioned (d): the compacted ssItem differs from a from-scratch create_index's")
    log(f"[partitioned] (d) optimized ssItem: {len(index_shas(hs, 'ssItem'))} files sha256-identical to a rebuild's")
    measure("d_optimized", ["bucketed", "general"], want, ["itemIdx", "ssItem"])

    # (e) a MinMax sketch on the partition column
    _, seconds["e_create_sketch"] = wall(lambda: hs.create_index(
        read("store_sales"), DataSkippingIndexConfig("ssDate", [MinMaxSketch(PART_COLUMN)])))
    lo, hi = date_sk("2001-11-01"), date_sk("2001-11-30")
    month = read("store_sales").filter((c(PART_COLUMN) >= lo) & (c(PART_COLUMN) <= hi)).group_by(
        "ss_store_sk").agg(net_paid=("ss_net_paid", "sum"), sales=("*", "count"))
    mask = ss["valid"] & (ss[PART_COLUMN] >= lo) & (ss[PART_COLUMN] <= hi)
    want_cols = {n: v[mask] for n, v in ss.items()}
    total_files = n_files + 1
    for label, on in (("e_month_indexed", True), ("e_month_disabled", False)):
        (hst.enable_hyperspace if on else hst.disable_hyperspace)(s)
        kept = len(scan_relation(month).files)
        if kept != (hi - lo + 1 if on else total_files):
            raise AssertionError(f"partitioned {label}: {kept} of {total_files} files kept:\n{month.explain_string()}")
        clear_caches()
        out, t_cold = wall(month.collect)
        check_skip(label, out, want_cols, "by_store")
        t = {"files_kept": kept, "files": total_files, "collect_cold_s": t_cold}
        # Streamed file by file over 1,827 files the disabled month takes
        # seconds a run on the card: one run of each kind keeps the phase short.
        runs = 3 if on else 1
        _, t[f"uncached_p50_of_{runs}_s"] = run_p50(month.collect, runs, uncached=True)
        out, t[f"cached_p50_of_{runs}_s"] = run_p50(month.collect, runs, uncached=False)
        check_skip(label, out, want_cols, "by_store")
        steps[label] = t
        log(f"[partitioned] {label} {json.dumps(t)}")
    hst.enable_hyperspace(s)

    # (f) item again as JSON lines
    s.write_json(tables["item"], src["item_json"])
    json_config = hst.IndexConfig("itemJson", ["i_item_sk"], ["i_brand_id", "i_brand", "i_manufact_id"])
    _, seconds["f_create_itemJson"] = wall(lambda: hs.create_index(read("item_json"), json_config))
    key = int(tables["item"]["i_item_sk"][ITEM_ROWS // 3])
    cols = ["i_item_sk", "i_brand_id", "i_brand", "i_manufact_id"]
    answers = {}
    for t in ("item_json", "item"):
        q = read(t).filter(c("i_item_sk") == key).select(*cols)
        name = "itemJson" if t == "item_json" else "itemIdx"
        if f"index={name}" not in q.explain_string():
            raise AssertionError(f"partitioned (f): the lookup over {t} does not scan {name}:\n{q.explain_string()}")
        answers[t] = q.collect().to_numpy()
    numpy_row = {n: tables["item"][n][[key - 1]] for n in cols}
    for t, got in answers.items():
        if not all(np.array_equal(np.asarray(got[n]).astype(numpy_row[n].dtype), numpy_row[n]) for n in cols):
            raise AssertionError(f"partitioned (f): the lookup over {t} gives {got}, numpy {numpy_row}")
    same_files = index_shas(hs, "itemJson") == index_shas(hs, "itemIdx")
    log(f"[partitioned] (f) lookup of i_item_sk {key} over JSON and {item_format} equals numpy; the two indexes' "
        f"sha256 sets equal: {same_files} (lineage names each source's files)")
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    if not launches["K2"]:
        raise AssertionError("partitioned: K2 never launched")
    seconds["phase"] = time.perf_counter() - phase_t0
    log(f"[partitioned] seconds {json.dumps(seconds)}; every step equals numpy; launches {json.dumps(launches)}")
    return launches, seconds, steps


# ---------------------------------------------------------------------------
# Phase setops: TPC-DS Q38 and Q87 over co-bucketed joins
# ---------------------------------------------------------------------------

CS_ROWS = 1_441_548  # TPC-DS SF1 catalog_sales
WS_ROWS = 719_384  # TPC-DS SF1 web_sales
CUSTOMER_ROWS = 100_000  # TPC-DS SF1 customer
FIRST_NAMES, LAST_NAMES = 2_000, 4_000  # generated names to draw from (this script's choice)
NULL_NAME_SHARE = 0.01  # customers with a null first or last name (this script's choice)
PLANT_SHARE = 0.01  # year-2000 store tickets whose (customer, date) a catalog and a web order repeat (this script's choice)
MONTH_SEQ_2000 = 1200  # d_month_seq of 2000-01
SYLLABLES = np.array(["ba", "ce", "di", "fo", "gu", "ha", "je", "ki", "lo", "mu", "na", "pe", "qui", "ro", "su",
                      "ta", "ve", "wi", "xo", "ya", "ze", "an", "el", "in", "or", "us"])
CHANNELS = {  # sales table: (its sale date column, its customer column)
    "store_sales": ("ss_sold_date_sk", "ss_customer_sk"),
    "catalog_sales": ("cs_sold_date_sk", "cs_bill_customer_sk"),
    "web_sales": ("ws_sold_date_sk", "ws_bill_customer_sk"),
}
SETOPS_INDEXES = [
    ("store_sales", "ssCust", ["ss_customer_sk"], ["ss_sold_date_sk"]),
    ("catalog_sales", "csCust", ["cs_bill_customer_sk"], ["cs_sold_date_sk"]),
    ("web_sales", "wsCust", ["ws_bill_customer_sk"], ["ws_sold_date_sk"]),
    ("customer", "custIdx", ["c_customer_sk"], ["c_first_name", "c_last_name"]),
]
SETOPS_SF1 = {"ss_rows": SS_ROWS, "cs_rows": CS_ROWS, "ws_rows": WS_ROWS, "customers": CUSTOMER_ROWS,
              "first_names": FIRST_NAMES, "last_names": LAST_NAMES}


def generated_names(rng, n: int) -> np.ndarray:
    """`n` distinct three-syllable names, capitalised."""
    k = len(SYLLABLES)
    picks = rng.choice(k ** 3, n, replace=False)
    return np.array([(SYLLABLES[p // k // k] + SYLLABLES[p // k % k] + SYLLABLES[p % k]).capitalize() for p in picks])


def channel_orders(rng, rows: int, first_day: int, last_day: int, customers: int, plant=None):
    """(sale date_sk, customer_sk) of `rows` sales lines in orders of 8-16
    lines of one date and customer, as the store tickets are, in date order;
    `plant` = (date_sk, customer_sk) arrays that as many random orders take."""
    sizes = rng.randint(8, 17, rows // 8 + 1)
    n_o = int(np.searchsorted(np.cumsum(sizes), rows)) + 1
    sizes = sizes[:n_o]
    sizes[-1] -= int(sizes.sum()) - rows
    o_date = SS_FIRST_DATE_SK + rng.randint(first_day, last_day + 1, n_o).astype(np.int64) - SS_FIRST_DAY
    o_cust = rng.randint(1, customers + 1, n_o).astype(np.int64)
    if plant is not None:
        at = rng.choice(n_o, len(plant[0]), replace=False)
        o_date[at], o_cust[at] = plant
    order = np.argsort(o_date, kind="stable")
    return np.repeat(o_date[order], sizes), np.repeat(o_cust[order], sizes)


def setops_tables(rng, ss_rows: int, cs_rows: int, ws_rows: int, customers: int, first_names: int,
                  last_names: int, first_day: int = SS_FIRST_DAY, last_day: int = SS_LAST_DAY,
                  plant_share: float = PLANT_SHARE) -> dict:
    """Q38's and Q87's tables: store_sales (the `store_sales` generator's
    rows, customers folded into 1..`customers`), catalog_sales and web_sales
    (`channel_orders`: the sale date and the billed customer), customer
    (`customers` rows, names drawn from `first_names` and `last_names`
    generated names, each null for `NULL_NAME_SHARE` of customers) and
    date_dim. A `plant_share` of the year-2000 store tickets has its
    (customer, date) repeated by one catalog order and one web order, so that
    Q38 does not come out empty by chance."""
    ss, _ = store_sales(rng, first_day, last_day, ss_rows)
    ss["ss_customer_sk"] = (ss["ss_customer_sk"] - 1) % customers + 1
    starts = np.concatenate([[0], np.nonzero(np.diff(ss["ss_ticket_number"]))[0] + 1])
    t_date, t_cust = ss["ss_sold_date_sk"][starts], ss["ss_customer_sk"][starts]
    y2000 = np.nonzero((t_date >= date_sk("2000-01-01")) & (t_date <= date_sk("2000-12-31")))[0]
    picked = rng.choice(y2000, int(round(plant_share * len(y2000))), replace=False)
    plant = (t_date[picked], t_cust[picked])
    tables = {"store_sales": ss}
    for table, rows in (("catalog_sales", cs_rows), ("web_sales", ws_rows)):
        date, cust = channel_orders(rng, rows, first_day, last_day, customers, plant)
        tables[table] = dict(zip(CHANNELS[table], (date, cust)))
    names = {}
    for col, n in (("c_first_name", first_names), ("c_last_name", last_names)):
        drawn = generated_names(rng, n)[rng.randint(0, n, customers)].astype(object)
        drawn[rng.rand(customers) < NULL_NAME_SHARE] = None
        names[col] = drawn
    tables["customer"] = {"c_customer_sk": np.arange(1, customers + 1, dtype=np.int64), **names}
    tables["date_dim"] = date_dim_table()
    return tables


def last_initial(name):
    """The UDF of phase setops: the first letter of a last name."""
    return None if name is None else name[:1]


def channel_branch(read, col, table: str):
    """One branch of Q38 and Q87 through either package's DataFrame API:
    the channel's sales ⋈ customer ⋈ date_dim (d_month_seq 1200-1211), the
    distinct (c_last_name, c_first_name, d_date). The customer join comes
    first, so that two covering indexes make it co-bucketed."""
    date_col, cust_col = CHANNELS[table]
    dd = read("date_dim").filter((col("d_month_seq") >= MONTH_SEQ_2000) & (col("d_month_seq") <= MONTH_SEQ_2000 + 11))
    return (
        read(table).join(read("customer"), col(cust_col) == col("c_customer_sk"))
        .join(dd, col(date_col) == col("d_date_sk"))
        .select("c_last_name", "c_first_name", "d_date")
        .distinct()
    )


def q38_query(read, col):
    """TPC-DS Q38's rows: the customers and days seen in all three channels."""
    store, catalog, web = (channel_branch(read, col, t) for t in CHANNELS)
    return store.intersect(catalog).intersect(web)


def q87_query(read, col):
    """TPC-DS Q87's rows: the customers and days seen in the stores only."""
    store, catalog, web = (channel_branch(read, col, t) for t in CHANNELS)
    return store.subtract(catalog).subtract(web)


def expected_setops(tables: dict) -> dict:
    """Each branch's rows, Q38's, Q87's and the union's as numpy-made sets of
    (c_last_name, c_first_name, d_date), None at a null name."""
    dd, cust = tables["date_dim"], tables["customer"]
    in_year = (dd["d_month_seq"] >= MONTH_SEQ_2000) & (dd["d_month_seq"] <= MONTH_SEQ_2000 + 11)
    out = {}
    for table, (date_col, cust_col) in CHANNELS.items():
        day = tables[table][date_col] - DD_FIRST_SK
        who = tables[table][cust_col] - 1
        keep = in_year[day]
        out[table] = set(zip(cust["c_last_name"][who[keep]], cust["c_first_name"][who[keep]],
                             dd["d_date"][day[keep]].tolist()))
    store, catalog, web = (out[t] for t in CHANNELS)
    out.update(q38=store & catalog & web, q87=store - catalog - web, union=store | catalog | web)
    return out


def row_set(table) -> list:
    """A collected table's rows as tuples of Python values, None at nulls."""
    cols = table.to_numpy()
    return list(zip(*(np.asarray(v, dtype=object).tolist() for v in cols.values())))


def check_setop_rows(label: str, rows: list, want: set, left_rows: list) -> None:
    """`rows` must be numpy's set, each row once, in the order of the left
    branch's rows (the left side's first occurrence, the JAX package's rule)."""
    if len(rows) != len(set(rows)) or set(rows) != want:
        raise AssertionError(f"{label}: {len(rows)} rows ({len(set(rows))} distinct), numpy {len(want)}")
    at = {r: i for i, r in enumerate(left_rows)}
    pos = [at[r] for r in rows]
    if pos != sorted(pos):
        raise AssertionError(f"{label}: the rows are not in the left branch's order")


def distinct_split(q) -> dict:
    """Seconds of the first branch's distinct in one more run: the host's
    blake2b of each string key column's dictionary (both seeds, as `key64`
    takes them), what a first query over a dictionary pays, beside the whole
    `hash_aggregate` over the same table, which the dictionary-hash memo
    spares it."""
    from hyperspace_tpu_torch.engine.physical import ExecContext, HashAggregateExec
    from hyperspace_tpu_torch.ops.aggregate import hash_aggregate
    from hyperspace_tpu_torch.ops.hashing import _SEED1, _SEED2, _hash_strings

    agg = next(n for n in q.physical_plan().collect_nodes() if isinstance(n, HashAggregateExec))
    t = agg.child.execute(ExecContext(q.session))
    dictionaries = [t.column(k).dictionary for k in agg.group_keys if t.column(k).is_string]
    out = {"rows": t.num_rows, "dictionary_entries": sum(len(d) for d in dictionaries)}
    _, out["host_dictionary_hash_s"] = wall(lambda: [_hash_strings(d, seed) for d in dictionaries
                                                     for seed in (_SEED1, _SEED2)])
    _, out["aggregate_s"] = wall(lambda: hash_aggregate(t, agg.group_keys, agg.aggs))
    return out


def phase_setops(torch, base: str, seed: int, sizes: dict = SETOPS_SF1):
    """TPC-DS Q38 and Q87 at SF1 in a directory of its own (`setops_tables`:
    store_sales 2,880,404 rows, catalog_sales 1,441,548, web_sales 719,384,
    customer 100,000, date_dim 73,049, made with numpy from `seed`); the
    covering indexes ssCust, csCust, wsCust and custIdx make each branch's
    sales ⋈ customer co-bucketed (K2; K1 in hash mode). Steps, each against
    numpy: (a) Q38 and Q87 indexed and disabled, count() cold, uncached p50
    of 3 and cached p50 of 3, an uncached run by stage; (b) Q38's rows in the
    left branch's order; (c) the three branches unioned and deduplicated;
    (d) Q38 over three views; (e) `Hyperspace.explain`, verbose; (f) Q38's
    plan serialized and back; (g) a UDF over Q38's rows, grouped; (h) show
    and scalar."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine.physical import SortMergeJoinExec
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort
    from hyperspace_tpu_torch.serde import deserialize_plan, serialize_plan

    rng = np.random.RandomState(seed + 17)
    phase_t0 = time.perf_counter()
    root = os.path.join(base, "setops")
    seconds = {}
    t0 = time.perf_counter()
    tables = setops_tables(rng, **sizes)
    seconds["generate"] = time.perf_counter() - t0
    s = hst.HyperspaceSession(warehouse=root, device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    t0 = time.perf_counter()
    for t, cols in tables.items():
        s.write_parquet(cols, os.path.join(root, t))
    seconds["write"] = time.perf_counter() - t0
    want = expected_setops(tables)
    log(f"[setops] rows {json.dumps({t: len(next(iter(c.values()))) for t, c in tables.items()})}; numpy: "
        f"{json.dumps({k: len(v) for k, v in want.items()})} (made in {seconds['generate']:.2f} s, written in "
        f"{seconds['write']:.2f} s)")

    def read(t):
        return s.read.parquet(os.path.join(root, t))

    c = hst.col
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    hs = hst.Hyperspace(s)
    for table, name, indexed, included in SETOPS_INDEXES:
        _, seconds[f"create_{name}"] = wall(lambda: hs.create_index(read(table), hst.IndexConfig(name, indexed, included)))
    hst.enable_hyperspace(s)
    index_names = sorted(n for _, n, _, _ in SETOPS_INDEXES)
    steps = {}

    def check_plan(label, q, indexed):
        joins = sorted("bucketed" if j.bucketed else "general"
                       for j in q.physical_plan().collect_nodes() if isinstance(j, SortMergeJoinExec))
        want_joins = sorted(["bucketed", "general"] * 3) if indexed else ["general"] * 6
        if joins != want_joins or sorted(set(scanned_indexes(q))) != (index_names if indexed else []):
            raise AssertionError(f"setops {label}: joins {joins}, indexes {scanned_indexes(q)}:\n{q.explain_string()}")

    # (a) Q38 and Q87, indexed and disabled
    for label, make in (("q38", q38_query), ("q87", q87_query)):
        for indexed in (True, False):
            (hst.enable_hyperspace if indexed else hst.disable_hyperspace)(s)
            step = f"a_{label}_{'indexed' if indexed else 'disabled'}"
            q = make(read, c)
            check_plan(step, q, indexed)
            k1, k2 = cuda_sort.launches, cuda_probe.launches
            clear_caches()
            n, t_cold = wall(q.count)
            t = {"count": n, "count_cold_s": t_cold}
            n_u, t["uncached_p50_s"] = run_p50(q.count, 3, uncached=True)
            n_c, t["cached_p50_s"] = run_p50(q.count, 3, uncached=False)
            if not n == n_u == n_c == len(want[label]):
                raise AssertionError(f"setops {step}: counts {n}, {n_u}, {n_c}; numpy {len(want[label])}")
            t["k1_launches"], t["k2_launches"] = cuda_sort.launches - k1, cuda_probe.launches - k2
            if indexed and not t["k2_launches"]:
                raise AssertionError(f"setops {step}: K2 never launched ({t})")
            stages = query_stage_split(torch, q, True)
            stages["distinct_s"] = stages.pop("aggregate_s")
            t["stages"] = stages
            t.update(device_busy(q))
            t["store_distinct"] = distinct_split(q)
            steps[step] = t
            log(f"[setops] {step} {json.dumps(t)}")
    hst.enable_hyperspace(s)

    # (b) Q38's rows
    q38 = q38_query(read, c)
    out, seconds["b_q38_collect_cold"] = wall(q38.collect)
    store_rows = row_set(channel_branch(read, c, "store_sales").collect())
    if set(store_rows) != want["store_sales"]:
        raise AssertionError("setops (b): the store branch's rows differ from numpy's")
    q38_rows = row_set(out)
    check_setop_rows("setops (b) q38", q38_rows, want["q38"], store_rows)
    check_setop_rows("setops (b) q87", row_set(q87_query(read, c).collect()), want["q87"], store_rows)
    log(f"[setops] (b) Q38's {len(q38_rows)} rows and Q87's equal numpy's sets, in the store branch's order")

    # (c) the union
    store, catalog, web = (channel_branch(read, c, t) for t in CHANNELS)
    n, seconds["c_union_distinct_count_cold"] = wall(store.union(catalog).union(web).distinct().count)
    if n != len(want["union"]):
        raise AssertionError(f"setops (c): union distinct {n}, numpy {len(want['union'])}")

    # (d) views
    for t, df in zip(CHANNELS, (store, catalog, web)):
        s.create_view(f"{t}_branch", df)
    via_views = (s.read.view("store_sales_branch").intersect(s.read.view("CATALOG_SALES_BRANCH"))
                 .intersect(s.read.view("web_sales_branch")))
    check_plan("(d) views", via_views, True)
    n, seconds["d_views_count"] = wall(via_views.count)
    if n != len(want["q38"]):
        raise AssertionError(f"setops (d): Q38 over views counts {n}, numpy {len(want['q38'])}")

    # (e) explain
    text = []
    _, seconds["e_explain"] = wall(lambda: hs.explain(q38, verbose=True, redirect=text.append))
    used = text[0].split("Indexes used:")[1].split("Physical operator stats:")[0]
    named = sorted(line.split(":")[0] for line in used.splitlines() if ":" in line and not line.startswith("="))
    m = re.search(r"ShuffleExchange\s*\|\s*(\d+)\|\s*(\d+)\|\s*(-?\d+)", text[0])
    if named != index_names or m is None or (int(m.group(1)), int(m.group(2))) != (12, 6):
        raise AssertionError(f"setops (e): explain names {named}, exchanges {m and m.groups()}:\n{text[0]}")
    log(f"[setops] (e) explain: indexes used {named}; ShuffleExchange disabled {m.group(1)}, enabled {m.group(2)}")

    # (f) the plan serialized and back
    back = hst.DataFrame(s, deserialize_plan(serialize_plan(q38.plan)))
    n, seconds["f_serde_count"] = wall(back.count)
    if n != len(want["q38"]) or back.explain_string() != q38.explain_string():
        raise AssertionError(f"setops (f): the deserialized Q38 counts {n} or explains otherwise")

    # (g) a UDF over Q38's rows: host work by contract
    initials = q38.with_column("initial", hst.udf(last_initial, "string")(c("c_last_name")))
    by_initial = initials.group_by("initial").agg(n=("*", "count"))
    got, seconds["g_udf_collect"] = wall(by_initial.collect)
    _, seconds["g_q38_collect_cached"] = wall(q38.collect)
    counts = {}
    for last, _, _ in want["q38"]:
        counts[last_initial(last)] = counts.get(last_initial(last), 0) + 1
    g = got.to_numpy()
    if dict(zip(g["initial"].tolist(), g["n"].tolist())) != counts:
        raise AssertionError(f"setops (g): counts by initial differ from numpy's {counts}")

    # (h) show and scalar
    q38.show(20, redirect=log)
    n, seconds["h_scalar"] = wall(q38.group_by().agg(n=("d_date", "count")).scalar)
    if n != len(want["q38"]):
        raise AssertionError(f"setops (h): scalar() {n}, numpy {len(want['q38'])}")
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    if not launches["K2"]:
        raise AssertionError("setops: K2 never launched")
    seconds["phase"] = time.perf_counter() - phase_t0
    log(f"[setops] seconds {json.dumps(seconds)}; every step equals numpy; launches {json.dumps(launches)}")
    return launches, seconds, steps


# ---------------------------------------------------------------------------
# Phase star: TPC-DS Q3 and Q55 as star joins over store_sales
# ---------------------------------------------------------------------------

STAR_INDEXES = [
    ("date_dim", "dateIdx", ["d_date_sk"], ["d_year", "d_moy"]),
    ("item", "itemIdx", ["i_item_sk"], ["i_brand_id", "i_brand", "i_manufact_id", "i_manager_id"]),
]
STAR_Q3_COLUMNS = ["d_year", "i_brand_id", "i_brand", "sum_agg"]
STAR_Q55_COLUMNS = ["i_brand_id", "i_brand", "ext_price"]
STAR_APPENDED_ITEMS = 1_000
STAR_WAYS = ("star", "cascade", "no_streaming", "disabled")


def star_tables(rng, ss_rows: int, items: int = ITEM_ROWS) -> dict:
    """store_sales (the `store_sales` generator's rows of 1998-01-02..
    2002-12-31, items drawn over 1..items, and ss_ext_sales_price =
    ss_quantity * ss_sales_price: TPC-DS's decimal(7,2) held exactly as
    int64 cents), each row's month (0 = 1998-01), item (as `tpcds_tables`
    makes it, plus i_manager_id uniform over TPC-DS's 1..100) and date_dim."""
    cols, month = store_sales(rng, SS_FIRST_DAY, SS_LAST_DAY, ss_rows)
    cols["ss_item_sk"] = rng.randint(1, items + 1, ss_rows).astype(np.int64)
    cols["ss_ext_sales_price"] = (cols["ss_quantity"] * cols["ss_sales_price"]).astype(np.int64)
    return {"store_sales": cols, "month": month, "item": star_items(rng, 1, items), "date_dim": date_dim_table()}


def star_items(rng, first: int, items: int) -> dict:
    brand_id = rng.randint(1, 1001, items).astype(np.int64)
    return {"i_item_sk": np.arange(first, first + items, dtype=np.int64), "i_brand_id": brand_id,
            "i_brand": np.array([f"brand #{b}" for b in brand_id]),
            "i_manufact_id": rng.randint(1, 1001, items).astype(np.int64),
            "i_manager_id": rng.randint(1, 101, items).astype(np.int64)}


def write_star_tables(s, tables: dict, root: str, files: int = SS_FILES) -> None:
    """store_sales as `files` monthly files (phase skipping's layout), item
    and date_dim as one file each."""
    from hyperspace_tpu_torch.engine import io as engine_io

    ss, month = tables["store_sales"], tables["month"]
    bounds = np.searchsorted(month, np.arange(files + 1) * (month.max() + 1) / files)
    for i in range(files):
        engine_io.write_parquet(source_table({n: v[bounds[i]:bounds[i + 1]] for n, v in ss.items()}),
                                os.path.join(root, "store_sales", f"part-{i:05d}.parquet"), SS_ROW_GROUP_ROWS)
    s.write_parquet(tables["item"], os.path.join(root, "item"))
    s.write_parquet(tables["date_dim"], os.path.join(root, "date_dim"))


def star_q3_query(read, col, measure: str = "ss_ext_sales_price", n: int = 100):
    """TPC-DS Q3 as a star: store_sales ⋈ date_dim (November) ⋈ item
    (manufacturer 128), the sales summed by year and brand, ORDER BY d_year,
    the sum descending and the brand id, LIMIT n."""
    dd = read("date_dim").filter(col("d_moy") == 11)
    item = read("item").filter(col("i_manufact_id") == 128)
    return (
        read("store_sales").join(dd, col("ss_sold_date_sk") == col("d_date_sk"))
        .join(item, col("ss_item_sk") == col("i_item_sk"))
        .group_by("d_year", "i_brand_id", "i_brand").agg(sum_agg=(measure, "sum"))
        .order_by("d_year", ("sum_agg", False), "i_brand_id").limit(n).select(*STAR_Q3_COLUMNS)
    )


def star_q55_query(read, col, measure: str = "ss_ext_sales_price", n: int = 100):
    """TPC-DS Q55 as a star: store_sales ⋈ date_dim (November 1999) ⋈ item
    (manager 28), the sales summed by brand, ORDER BY the sum descending and
    the brand id, LIMIT n."""
    dd = read("date_dim").filter((col("d_moy") == 11) & (col("d_year") == 1999))
    item = read("item").filter(col("i_manager_id") == 28)
    return (
        read("store_sales").join(dd, col("ss_sold_date_sk") == col("d_date_sk"))
        .join(item, col("ss_item_sk") == col("i_item_sk"))
        .group_by("i_brand_id", "i_brand").agg(ext_price=(measure, "sum"))
        .order_by(("ext_price", False), "i_brand_id").limit(n).select(*STAR_Q55_COLUMNS)
    )


STAR_QUERIES = {  # step: (query, measure)
    "a_q3": (star_q3_query, "ss_ext_sales_price"),
    "b_q55": (star_q55_query, "ss_ext_sales_price"),
    "c_q55_float": (star_q55_query, "ss_net_paid"),
}


def expected_star(tables: dict, step: str) -> dict:
    """A step's query over the generated arrays with numpy, every group in
    the query's order (integer sums exact, float sums by `np.add.at`)."""
    ss, item, dd = tables["store_sales"], tables["item"], tables["date_dim"]
    measure = STAR_QUERIES[step][1]
    it = np.searchsorted(item["i_item_sk"], ss["ss_item_sk"])
    day = ss["ss_sold_date_sk"] - DD_FIRST_SK
    if step == "a_q3":
        keep = (item["i_manufact_id"][it] == 128) & (dd["d_moy"][day] == 11)
        key_cols = {"d_year": dd["d_year"][day[keep]], "i_brand_id": item["i_brand_id"][it[keep]]}
    else:
        keep = (item["i_manager_id"][it] == 28) & (dd["d_moy"][day] == 11) & (dd["d_year"][day] == 1999)
        key_cols = {"i_brand_id": item["i_brand_id"][it[keep]]}
    keys, inv = np.unique(np.stack(list(key_cols.values())), axis=1, return_inverse=True)
    vals = ss[measure][keep]
    total = np.zeros(keys.shape[1], vals.dtype)
    np.add.at(total, inv.reshape(-1), vals)
    brand = keys[-1]
    by = np.lexsort((brand, -total, keys[0])) if step == "a_q3" else np.lexsort((brand, -total))
    out = {n: keys[i][by] for i, n in enumerate(key_cols)}
    out["i_brand"] = np.array([f"brand #{b}" for b in brand[by]])
    out["sum_agg" if step == "a_q3" else "ext_price"] = total[by]
    return {n: out[n] for n in (STAR_Q3_COLUMNS if step == "a_q3" else STAR_Q55_COLUMNS)}


def check_star_rows(label: str, got: dict, want: dict, n: int = 100) -> None:
    """`got` must be numpy's first n rows in order: integer sums exactly,
    float sums at rtol 1e-9, where rows whose float sums tie within that
    tolerance (in one year for Q3) may swap places."""
    names = list(want)
    total, m = want[names[-1]], min(n, len(want[names[-1]]))
    if list(got) != names or len(got[names[-1]]) != m:
        raise AssertionError(f"{label}: columns {list(got)}, {len(got[names[-1]])} rows; want {names}, {m}")
    lead = want["d_year"] if "d_year" in want else np.zeros(len(total), np.int64)
    exact = np.issubdtype(total.dtype, np.integer)
    tie = (total[1:] == total[:-1]) if exact else np.isclose(total[1:], total[:-1], rtol=1e-9, atol=0)
    cls = np.concatenate([[0], np.cumsum(~(tie & (lead[1:] == lead[:-1])))])
    key = np.asarray(got["i_brand_id"]).astype(np.int64) + 10_000 * (
        np.asarray(got["d_year"]).astype(np.int64) if "d_year" in got else 0)
    wkey = want["i_brand_id"] + 10_000 * (want["d_year"] if "d_year" in want else 0)
    for c in np.unique(cls[:m]):
        pos, members = np.nonzero(cls[:m] == c)[0], np.nonzero(cls == c)[0]
        have, allowed = set(key[pos].tolist()), set(wkey[members].tolist())
        if not (have <= allowed if members[-1] >= m else have == allowed):
            raise AssertionError(f"{label}: rows {pos.tolist()} hold groups {sorted(have)}, numpy {sorted(allowed)}")
        if exact and not np.array_equal(key[pos], wkey[members[: len(pos)]]):
            raise AssertionError(f"{label}: rows {pos.tolist()} out of numpy's order")
    at = {k: i for i, k in enumerate(wkey.tolist())}
    idx = np.array([at[k] for k in key.tolist()], np.int64)
    if list(got["i_brand"]) != list(want["i_brand"][idx]):
        raise AssertionError(f"{label}: i_brand differs from numpy's")
    sums = np.asarray(got[names[-1]])
    if exact and not np.array_equal(sums.astype(np.int64), total[idx]):
        raise AssertionError(f"{label}: {names[-1]} differs from numpy's")
    if not exact and not np.allclose(sums.astype(np.float64), total[idx], rtol=1e-9, atol=0):
        raise AssertionError(f"{label}: {names[-1]} differs from numpy's beyond rtol 1e-9")


def star_way(hst, s, way: str):
    """Set one way of running a star query: the star stream (defaults), the
    cascade (`HYPERSPACE_MULTIWAY=0`), no streaming
    (`HYPERSPACE_QUERY_STREAMING=0`) or Hyperspace disabled; whether it must
    plan a `MultiwayJoinExec` (where the JAX package plans one)."""
    for flag in ("HYPERSPACE_MULTIWAY", "HYPERSPACE_QUERY_STREAMING"):
        os.environ.pop(flag, None)
    if way == "cascade":
        os.environ["HYPERSPACE_MULTIWAY"] = "0"
    if way == "no_streaming":
        os.environ["HYPERSPACE_QUERY_STREAMING"] = "0"
    (hst.disable_hyperspace if way == "disabled" else hst.enable_hyperspace)(s)
    return way in ("star", "no_streaming")


def star_store_query(read):
    """(d): a grouped aggregate over the 60 files, streamed by default."""
    return read("store_sales").group_by("ss_store_sk").agg(
        n=("*", "count"), ext=("ss_ext_sales_price", "sum"), paid=("ss_net_paid", "sum"),
        qmin=("ss_quantity", "min"), qmax=("ss_quantity", "max"), avg_paid=("ss_net_paid", "avg"))


def expected_store_agg(ss: dict) -> dict:
    keys, inv = np.unique(ss["ss_store_sk"], return_inverse=True)
    n = np.bincount(inv)
    ext = np.zeros(len(keys), np.int64)
    np.add.at(ext, inv, ss["ss_ext_sales_price"])
    paid = np.bincount(inv, weights=ss["ss_net_paid"])
    qmin = np.full(len(keys), np.iinfo(np.int64).max)
    np.minimum.at(qmin, inv, ss["ss_quantity"])
    qmax = np.zeros(len(keys), np.int64)
    np.maximum.at(qmax, inv, ss["ss_quantity"])
    return {"ss_store_sk": keys, "n": n, "ext": ext, "paid": paid, "qmin": qmin, "qmax": qmax, "avg_paid": paid / n}


def check_store_agg(label: str, got: dict, want: dict) -> None:
    order = np.argsort(got["ss_store_sk"], kind="stable")
    for k in ("ss_store_sk", "n", "ext", "qmin", "qmax"):
        if not np.array_equal(np.asarray(got[k])[order].astype(np.int64), want[k]):
            raise AssertionError(f"{label}: {k} differs from numpy's")
    for k in ("paid", "avg_paid"):
        if not np.allclose(np.asarray(got[k])[order].astype(np.float64), want[k], rtol=1e-9, atol=0):
            raise AssertionError(f"{label}: {k} differs from numpy's beyond rtol 1e-9")


def star_stage_split(stats: dict) -> dict:
    """The stage split of a star stream's record: per dimension its pad,
    probe (with expand) and verify seconds, then the stream's own stages."""
    out = {d["index"]: {k: d.get(k) for k in ("pairs", "memo", "pad_s", "probe_s", "verify_s")}
           for d in stats["star_dims"]}
    out.update({k: stats.get(k) for k in ("pad_s", "probe_s", "expand_s", "verify_s", "gather_s", "eval_s",
                                          "partial_s", "merge_s", "finalize_s", "wall_s", "chunks", "pairs",
                                          "direct_cells")})
    return out


def phase_star(torch, base: str, seed: int, ss_rows: int = SS_ROWS):
    """TPC-DS Q3 and Q55 as star joins in a directory of their own
    (`star_tables`, made with numpy from `seed`): store_sales (2,880,404
    rows, not indexed) as 60 monthly files, item (18,000 rows) and date_dim
    (73,049) under covering indexes dateIdx and itemIdx. Each star query
    hashes the fact's keys into each dimension's buckets, pads and sorts the
    classes (K1) and probes them (K2). Steps, each against numpy: (a) Q3,
    (b) Q55, (c) Q55 with a float sum of ss_net_paid (the direct-cells
    path), each run four ways: the star stream (`join_mode == "star"`), the
    cascade (`HYPERSPACE_MULTIWAY=0`), streaming off
    (`HYPERSPACE_QUERY_STREAMING=0`) and disabled, each with its plan's
    `MultiwayJoinExec` where the JAX package plans one; cold count(),
    uncached and cached collect() p50 of 3, the star's stage split, the
    device's busy share and K1 and K2 launches; (d) a streamed scan
    aggregate over the 60 files and its one-pass twin; (e) 1,000 items
    appended as a second item file and a month of store_sales rows over all
    items appended: Q55 under Hybrid Scan."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.physical import MultiwayJoinExec
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort
    from hyperspace_tpu_torch.telemetry.profiling import last_build_stages, last_join_stages, last_query_stages

    rng = np.random.RandomState(seed + 19)
    phase_t0 = time.perf_counter()
    root = os.path.join(base, "star")
    seconds = {}
    tables, seconds["generate"] = wall(lambda: star_tables(rng, ss_rows))
    s = hst.HyperspaceSession(warehouse=root, device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    _, seconds["write"] = wall(lambda: write_star_tables(s, tables, root))

    def read(t):
        return s.read.parquet(os.path.join(root, t))

    c = hst.col
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    hs = hst.Hyperspace(s)
    build_stages = {}
    for table, name, indexed, included in STAR_INDEXES:
        k1 = cuda_sort.launches
        _, seconds[f"create_{name}"] = wall(lambda: hs.create_index(read(table), hst.IndexConfig(name, indexed,
                                                                                                  included)))
        build_stages[name] = dict(last_build_stages(), k1_launches=cuda_sort.launches - k1)
        log(f"[star] {name} build stages {json.dumps(build_stages[name])}")
    item = build_stages["itemIdx"]
    if item["sort_route"] != "composite" or not item["k1_launches"]:
        raise AssertionError(f"star: itemIdx's build must sort on K1 (the composite route): {item}")
    # itemIdx again in a CPU session (K1's plain version), in a second
    # warehouse: the same files.
    s_cpu = hst.HyperspaceSession(warehouse=os.path.join(root, "cpu_wh"), device="cpu")
    s_cpu.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    table, _, indexed, included = next(i for i in STAR_INDEXES if i[1] == "itemIdx")
    _, seconds["create_itemIdx_cpu"] = wall(lambda: hst.Hyperspace(s_cpu).create_index(
        s_cpu.read.parquet(os.path.join(root, table)), hst.IndexConfig("itemIdx", indexed, included)))
    if index_files(s, "itemIdx") != index_files(s_cpu, "itemIdx"):
        raise AssertionError("star: itemIdx's builds on the card and on the CPU wrote different files")
    del s_cpu
    shutil.rmtree(os.path.join(root, "cpu_wh"))
    log(f"[star] store_sales {ss_rows} rows in {SS_FILES} files, item {len(tables['item']['i_item_sk'])}, date_dim "
        f"{DD_ROWS}; {json.dumps(seconds)}")
    steps = {}

    def measure(step, way, q, want, check):
        wants_star = star_way(hst, s, way)
        stars = [n for n in q.physical_plan().collect_nodes() if isinstance(n, MultiwayJoinExec)]
        if len(stars) != int(wants_star) or (stars and len(stars[0].dims) != 2):
            raise AssertionError(f"star {step} {way}: {len(stars)} MultiwayJoinExec:\n{q.explain_string()}")
        label = f"{step}_{way}"
        k1, k2 = cuda_sort.launches, cuda_probe.launches
        clear_caches()
        before = last_join_stages()
        n, t_cold = wall(q.count)
        t = {"count": n, "count_cold_s": t_cold}
        out, t["uncached_p50_s"] = run_p50(q.collect, 3, uncached=True)
        check(label, out.to_numpy(), want)
        stats = last_join_stages()
        streamed = stats is not None and stats != before and stats.get("join_mode") == "star"
        if streamed != (way == "star"):
            raise AssertionError(f"star {label}: the star stream ran {streamed} ({stats})")
        if streamed:
            t["stages_uncached"] = star_stage_split(stats)
        out, t["cached_p50_s"] = run_p50(q.collect, 3, uncached=False)
        check(label, out.to_numpy(), want)
        if n != out.num_rows:
            raise AssertionError(f"star {label}: count() {n} != {out.num_rows} rows")
        if streamed:
            t["stages_cached"] = star_stage_split(last_join_stages())
        t["k1_launches"], t["k2_launches"] = cuda_sort.launches - k1, cuda_probe.launches - k2
        if way == "star" and not (t["k1_launches"] and t["k2_launches"]):
            raise AssertionError(f"star {label}: K1 or K2 never launched ({t})")
        t.update(device_busy(q))
        engine_io.reset_io_stats()
        t["stages"] = query_stage_split(torch, q, True)
        t["scan_parts"] = engine_io.io_stats()["seconds"]
        steps[label] = t
        log(f"[star] {label} {json.dumps(t)}")
        return out

    for step, (make, measure_col) in STAR_QUERIES.items():
        want = expected_star(tables, step)
        q = make(read, c, measure_col)
        for way in STAR_WAYS:
            measure(step, way, q, want, check_star_rows)
    star_way(hst, s, "star")
    log(f"[star] (a)-(c) Q3, Q55 and the float Q55 equal numpy in all four ways")

    # (d) the streamed scan aggregate
    want = expected_store_agg(tables["store_sales"])
    q = star_store_query(read)
    for way in ("star", "no_streaming"):
        star_way(hst, s, way)
        before = last_query_stages()
        clear_caches()
        out, t_cold = wall(q.collect)
        check_store_agg(f"star d_{way}", out.to_numpy(), want)
        stats = last_query_stages()
        streamed = stats is not None and stats != before
        if streamed != (way == "star") or (streamed and stats["chunks"] != SS_FILES):
            raise AssertionError(f"star d_{way}: streamed {streamed} ({stats})")
        t = {"collect_cold_s": t_cold, "stream": stats if streamed else None}
        out, t["uncached_p50_s"] = run_p50(q.collect, 3, uncached=True)
        check_store_agg(f"star d_{way}", out.to_numpy(), want)
        _, t["cached_p50_s"] = run_p50(q.collect, 3, uncached=False)
        t.update(device_busy(q))
        steps[f"d_store_agg_{way}"] = t
        log(f"[star] d_store_agg_{way} {json.dumps(t)}")
    star_way(hst, s, "star")

    # (e) Hybrid Scan: items appended, and a month of sales over all items
    new_items = star_items(rng, ITEM_ROWS + 1, STAR_APPENDED_ITEMS)
    s.write_parquet(new_items, os.path.join(root, "item_new"))
    os.replace(os.path.join(root, "item_new", "part-00000.parquet"), os.path.join(root, "item", "part-00001.parquet"))
    extra, _ = store_sales(rng, days("1999-11-01"), days("1999-11-30"), ss_rows // SS_FILES,
                           ticket_base=int(tables["store_sales"]["ss_ticket_number"].max()))
    extra["ss_item_sk"] = rng.randint(1, ITEM_ROWS + STAR_APPENDED_ITEMS + 1, len(extra["ss_item_sk"])).astype(np.int64)
    extra["ss_ext_sales_price"] = (extra["ss_quantity"] * extra["ss_sales_price"]).astype(np.int64)
    engine_io.write_parquet(source_table(extra), os.path.join(root, "store_sales", f"part-{SS_FILES:05d}.parquet"))
    tables["store_sales"] = {n: np.concatenate([v, extra[n]]) for n, v in tables["store_sales"].items()}
    tables["item"] = {n: np.concatenate([v, new_items[n]]) for n, v in tables["item"].items()}
    s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    q = star_q55_query(read, c)
    if "(+1 appended)" not in q.explain_string():
        raise AssertionError(f"star (e): no Hybrid Scan over the appended items:\n{q.explain_string()}")
    measure("e_q55_hybrid", "star", q, expected_star(tables, "b_q55"), check_star_rows)
    s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "false")

    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    seconds["phase"] = time.perf_counter() - phase_t0
    log(f"[star] seconds {json.dumps(seconds)}; every step equals numpy; launches {json.dumps(launches)}")
    return launches, seconds, steps


# ---------------------------------------------------------------------------
# Resilience and the planner's model arm: chunk shaping, faults, corruption,
# deadlines and the live-table fault windows
# ---------------------------------------------------------------------------

PROBE_FILES = 8  # SF1's lineitem rows (6,000,000) as 8 files of 750,000
PROBE_ROWS = 750_000
PROBE_FILLERS = 18
FAULT_SPEC = "io.decode:0.3:transient"
FAULT_SEED = "3"  # io.decode's draws at rate 0.3 begin ..X..X.X.....X..X
LIVE_FILES = 5  # orders as 5 files of o_orderkey ranges; file 4 appended later


def write_probe_files(rng, root: str) -> dict:
    """ROADMAP Queue 3's probe at SF1's lineitem row count: `g` an int in
    0..99, `p` = rand × 1000 and 18 float64 fillers, made from the seed and
    written with pyarrow. Returns numpy's group sums and counts."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(root, exist_ok=True)
    sums, counts = np.zeros(100), np.zeros(100, np.int64)
    for i in range(PROBE_FILES):
        g = rng.randint(0, 100, PROBE_ROWS).astype(np.int64)
        p = rng.rand(PROBE_ROWS) * 1000
        cols = {"g": g, "p": p}
        for j in range(PROBE_FILLERS):
            cols[f"f{j:02d}"] = rng.rand(PROBE_ROWS)
        pq.write_table(pa.table(cols), os.path.join(root, f"part-{i:05d}.parquet"))
        sums += np.bincount(g, weights=p, minlength=100)
        counts += np.bincount(g, minlength=100)
    return {"g": np.arange(100), "s": sums, "c": counts}


def check_probe_agg(label: str, got: dict, want: dict) -> None:
    order = np.argsort(got["g"])
    if not np.array_equal(np.asarray(got["g"])[order], want["g"]):
        raise AssertionError(f"{label}: groups differ from numpy's")
    if not np.array_equal(np.asarray(got["c"])[order], want["c"]):
        raise AssertionError(f"{label}: counts differ from numpy's")
    if not np.allclose(np.asarray(got["s"])[order], want["s"], rtol=1e-9, atol=0):
        raise AssertionError(f"{label}: sums differ from numpy's beyond rtol 1e-9")


def entry_counts() -> dict:
    """Decoded columns in the per-file scan cache, tables in the other scan
    caches, and entries of the join memos: what a query leaves on the card."""
    from hyperspace_tpu_torch.engine import physical, scan_cache

    st = scan_cache.stats()
    return {"scan_columns": st["scan"]["columns"], "bucketed_concat": st["bucketed_concat"]["entries"],
            "concat": st["concat"]["entries"], "filtered": st["filtered"]["entries"],
            "memos": physical.device_cache_stats()["entries"]}


def phase_resilience(torch, data, base: str, seed: int):
    """Steps (a)-(e) of the resilience phase (module docstring, phase 14)."""
    import warnings

    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch import resilience
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine import physical
    from hyperspace_tpu_torch.exceptions import QueryTimeoutError, TransientError
    from hyperspace_tpu_torch.index import quarantine
    from hyperspace_tpu_torch.index.staging import STAGING_PREFIX
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort
    from hyperspace_tpu_torch.plananalysis import costmodel, planner
    from hyperspace_tpu_torch.telemetry import faults
    from hyperspace_tpu_torch.telemetry.profiling import last_query_stages

    phase_t0 = time.perf_counter()
    root = os.path.join(base, "resilience")
    reset_launches(cuda_sort)
    reset_launches(cuda_probe, cuda_hash)
    quarantine.clear()
    faults.clear()
    faults.reset_counters()
    resilience.reset_counters()
    seconds, steps = {}, {}

    # (a) the planner shapes a warm aggregate's chunks from its footers.
    t0 = time.perf_counter()
    want = write_probe_files(np.random.RandomState(seed), os.path.join(root, "probe"))
    seconds["a_data"] = time.perf_counter() - t0
    s = hst.HyperspaceSession(warehouse=root, device=DEVICE)
    probe = s.read.parquet(os.path.join(root, "probe")).group_by("g").agg(s=("p", "sum"), c=("*", "count"))
    clear_caches()
    runs = {}
    for run in ("cold", "warm"):
        out, t = wall(probe.collect)
        check_probe_agg(f"resilience (a) {run}", out.to_numpy(), want)
        d = planner.last_decisions()
        runs[run] = {"chunks": last_query_stages()["chunks"], "chunk_rows": d.decisions["chunk_rows"].value,
                     "hash_quantize": d.decisions["hash_quantize"].arm, "calibration": d.calibration_source,
                     "collect_s": t}
    st = costmodel.collect_stats(probe.physical_plan())
    per_row = st.decoded_bytes / st.rows
    shaped = costmodel._pow2(int(costmodel._TARGET_CHUNK_BYTES / per_row))
    cal = costmodel.current_calibration(torch.device(DEVICE))
    arithmetic = {"warm_files": st.warm_files, "files": st.n_files, "rows": st.rows,
                  "decoded_bytes": st.decoded_bytes, "bytes_per_row": per_row,
                  "64MiB_over_bytes_per_row": costmodel._TARGET_CHUNK_BYTES / per_row, "pow2": shaped,
                  "calibration": {"source": cal.source, "memcpy_gbps": cal.memcpy_gbps}}
    log(f"[resilience] (a) runs {json.dumps(runs)}; chunk arithmetic from the footers {json.dumps(arithmetic)}")
    if runs["cold"]["chunk_rows"] != costmodel._DEFAULT_CHUNK_ROWS or runs["warm"]["chunk_rows"] != shaped:
        raise AssertionError(f"resilience (a): decided chunk_rows {runs}, want 4,000,000 cold and {shaped} warm")
    if not runs["warm"]["chunks"] > runs["cold"]["chunks"]:
        raise AssertionError(f"resilience (a): warm must stream more chunks than cold: {runs}")
    if runs["warm"]["hash_quantize"] != "on" or cal.source != "measured":
        raise AssertionError(f"resilience (a): a CUDA session's decisions: {runs}, calibration {cal}")
    steps["a_planner"] = {"runs": runs, "arithmetic": arithmetic}
    del want, probe
    shutil.rmtree(os.path.join(root, "probe"), ignore_errors=True)

    # (b) Q3 indexed (value mode, K2) and a string-key join (hash mode, K1
    # and K2) under transient decode faults: the rows of the clean runs.
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    key_kind_sources(torch, data, base, seed)
    t0 = time.perf_counter()
    for src, name, indexed, included in Q3_INDEXES + [KEY_KIND_INDEXES[0], KEY_KIND_INDEXES[1]]:
        hs.create_index(s.read.parquet(os.path.join(base, "src", src)), hst.IndexConfig(name, indexed, included))
    seconds["b_build"] = time.perf_counter() - t0
    hst.enable_hyperspace(s)

    def rd(t):
        return s.read.parquet(os.path.join(base, "src", t))

    q3 = q3_query(rd, hst.col)
    names = (rd("customer").join(rd("customer_copy"), hst.col("c_name") == hst.col("c2_name"))
             .select("c_custkey", "c2_custkey"))
    q3_want = expected_q3(data)
    if scanned_indexes(q3) != ["liQ3", "ordQ3"] or scanned_indexes(names) != ["custName", "custName2"]:
        raise AssertionError(f"resilience (b): the plans do not scan the indexes:\n{q3.explain_string()}\n"
                             f"{names.explain_string()}")
    clean = {}
    for label, df in (("q3", q3), ("string_key", names)):
        clear_caches()
        clean[label], seconds[f"b_{label}_clean_s"] = wall(df.collect)
    check_q3("resilience (b) q3", clean["q3"].to_numpy(), q3_want)
    cu = data["customer"]
    if not same_multiset(clean["string_key"].to_numpy(), canonical({"c_custkey": cu["c_custkey"],
                                                                     "c2_custkey": cu["c_custkey"]})):
        raise AssertionError("resilience (b): the string-key join differs from numpy's")
    saved = {k: os.environ.get(k) for k in ("HYPERSPACE_FAULTS", "HYPERSPACE_FAULTS_SEED", "HYPERSPACE_IO_RETRIES",
                                            "HYPERSPACE_RETRY_BACKOFF_S")}
    # Thread order decides which file draws which call, so the retry bound
    # is raised as the JAX package's chaos leg raises it (0.3^13 a file).
    os.environ.update({"HYPERSPACE_FAULTS": FAULT_SPEC, "HYPERSPACE_FAULTS_SEED": FAULT_SEED,
                       "HYPERSPACE_IO_RETRIES": "12", "HYPERSPACE_RETRY_BACKOFF_S": "0.001"})
    try:
        chaos = {}
        for label, df in (("q3", q3), ("string_key", names)):
            k1, k2 = cuda_sort.launches, cuda_probe.launches
            clear_caches()
            got, t = wall(df.collect)
            if not all(np.array_equal(a, b) for a, b in zip(got.to_numpy().values(), clean[label].to_numpy().values())):
                raise AssertionError(f"resilience (b) {label}: rows under {FAULT_SPEC} differ from the clean run's")
            chaos[label] = {"collect_s": t, "k1_launches": cuda_sort.launches - k1,
                            "k2_launches": cuda_probe.launches - k2}
        chaos.update(decode_calls=faults.call_count("io.decode"), injected=faults.injected_count("io.decode"),
                     retries=resilience.counters().get("io.retries.attempts", 0))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"[resilience] (b) under {FAULT_SPEC} (seed {FAULT_SEED}) {json.dumps(chaos)}; the rows equal the clean "
        "runs'")
    if not chaos["injected"] or not chaos["retries"]:
        raise AssertionError(f"resilience (b): no fault was injected or retried: {chaos}")
    if not (chaos["q3"]["k2_launches"] and chaos["string_key"]["k1_launches"] and chaos["string_key"]["k2_launches"]):
        raise AssertionError(f"resilience (b): K1 and K2 must launch under faults: {chaos}")
    steps["b_faults"] = chaos

    # (c) a corrupt bucket file of liQ3: quarantine, the source's answer
    # through the general join, then a refresh lifts the mark.
    entry = [e for e in hs._manager.get_indexes() if e.name == "liQ3"][0]
    victim = sorted(p for p in entry.content.files() if p.endswith(".parquet"))[0]
    with open(victim, "wb") as f:
        f.write(b"not a parquet file")
    clear_caches()
    k1, k2 = cuda_sort.launches, cuda_probe.launches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, t = wall(q3.collect)
    said = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    corrupt = {"collect_s": t, "warnings": len(said), "quarantined": sorted(quarantine.snapshot()),
               "k1_launches": cuda_sort.launches - k1, "k2_launches": cuda_probe.launches - k2,
               "plan_indexes": scanned_indexes(q3)}
    if len(said) != 1 or "'liQ3' quarantined" not in said[0] or corrupt["quarantined"] != ["liQ3"]:
        raise AssertionError(f"resilience (c): want one warning quarantining liQ3: {said} {corrupt}")
    if corrupt["k1_launches"] or corrupt["k2_launches"] or corrupt["plan_indexes"]:
        raise AssertionError(f"resilience (c): the fallback must run the general join, no kernel: {corrupt}")
    check_q3("resilience (c) fallback", got.to_numpy(), q3_want)
    _, corrupt["refresh_s"] = wall(lambda: hs.refresh_index("liQ3", "auto"))
    if quarantine.is_quarantined("liQ3") or scanned_indexes(q3) != ["liQ3", "ordQ3"]:
        raise AssertionError(f"resilience (c): the refresh did not lift the mark:\n{q3.explain_string()}")
    clear_caches()
    k2 = cuda_probe.launches
    got, corrupt["after_refresh_collect_s"] = wall(q3.collect)
    corrupt["after_refresh_k2_launches"] = cuda_probe.launches - k2
    check_q3("resilience (c) after refresh", got.to_numpy(), q3_want)
    if not corrupt["after_refresh_k2_launches"]:
        raise AssertionError(f"resilience (c): K2 did not launch after the refresh: {corrupt}")
    log(f"[resilience] (c) corrupt {os.path.basename(victim)} of liQ3 {json.dumps(corrupt)}; both answers equal "
        "numpy's Q3")
    steps["c_corruption"] = corrupt

    # (d) a deadline: a hang at every decode outlives 0.05 s; the timed-out
    # query leaves no entry on the card.
    clear_caches()
    before = entry_counts()
    os.environ["HYPERSPACE_QUERY_TIMEOUT_S"] = "0.05"
    t0 = time.perf_counter()
    try:
        with faults.inject("io.decode", rate=1.0, kind="hang0.2"):
            q3.collect()
        raise AssertionError("resilience (d): the query outlived its deadline without QueryTimeoutError")
    except QueryTimeoutError as e:
        deadline = {"raised_after_s": time.perf_counter() - t0, "message": str(e)[:120]}
    finally:
        os.environ.pop("HYPERSPACE_QUERY_TIMEOUT_S", None)
    torch.cuda.synchronize()
    after = entry_counts()
    deadline.update(before=before, after=after)
    if after != before:
        raise AssertionError(f"resilience (d): the timed-out query left entries: {before} -> {after}")
    got, deadline["collect_s"] = wall(q3.collect)
    check_q3("resilience (d) after the deadline", got.to_numpy(), q3_want)
    deadline["after_success"] = entry_counts()
    log(f"[resilience] (d) {json.dumps(deadline)}")
    steps["d_deadline"] = deadline

    # (e) the live-table fault windows of refresh and compaction.
    live_src = os.path.join(root, "orders_live")
    od = data["orders"]
    bounds = np.linspace(0, len(od["o_orderkey"]), LIVE_FILES + 1).astype(np.int64)

    def write_live(i):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        engine_io.write_parquet(source_table({"o_orderkey": od["o_orderkey"][lo:hi], "o_custkey": od["o_custkey"][lo:hi]}),
                                os.path.join(live_src, f"part-{i:05d}.parquet"))

    for i in range(LIVE_FILES - 1):
        write_live(i)
    s.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    live = {}
    _, live["create_s"] = wall(lambda: hs.create_index(s.read.parquet(live_src),
                                                      hst.IndexConfig("ordLive", ["o_orderkey"], ["o_custkey"])))
    s.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "false")

    def lookup(row: int, indexed: bool) -> None:
        key = int(od["o_orderkey"][row])
        df = s.read.parquet(live_src).filter(hst.col("o_orderkey") == key).select("o_orderkey", "o_custkey")
        if indexed and "ordLive" not in df.explain_string():
            raise AssertionError(f"resilience (e): the lookup does not scan ordLive:\n{df.explain_string()}")
        got = df.collect().to_numpy()
        if got["o_orderkey"].tolist() != [key] or got["o_custkey"].tolist() != [int(od["o_custkey"][row])]:
            raise AssertionError(f"resilience (e): lookup of {key} gave {got}")

    def state() -> tuple:
        hs._manager.clear_cache()
        e = [e for e in hs._manager.get_indexes() if e.name == "ordLive"][0]
        return e.state, sorted({os.path.basename(os.path.dirname(p)) for p in e.content.files()})

    write_live(LIVE_FILES - 1)
    appended = int(bounds[LIVE_FILES - 1])
    for window, action in (("refresh.merge", lambda: hs.refresh_index("ordLive", "incremental")),
                           ("compact.commit", lambda: hs.optimize_index("ordLive"))):
        stable = state()
        try:
            with faults.inject(window, kind="transient"):
                action()
            raise AssertionError(f"resilience (e): {window} did not fail")
        except TransientError:
            pass
        staging = [n for n in os.listdir(os.path.join(root, "indexes", "ordLive")) if n.startswith(STAGING_PREFIX)]
        if state() != stable or staging:
            raise AssertionError(f"resilience (e) {window}: {state()} after the fault, {stable} before; "
                                 f"staging {staging}")
        clear_caches()
        lookup(0, indexed=window == "compact.commit")  # the stable generation answers
        _, live[f"{window}_retry_s"] = wall(action)
        clear_caches()
        lookup(appended, indexed=True)
        lookup(0, indexed=True)
        live[window] = {"stable": stable, "after_retry": state()}
    log(f"[resilience] (e) {json.dumps(live)}; each fault failed clean and the stable generation answered")
    steps["e_live"] = live

    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    seconds["phase"] = time.perf_counter() - phase_t0
    log(f"[resilience] seconds {json.dumps(seconds)}; reliability {json.dumps(resilience.reliability_rollup())}; "
        f"launches {json.dumps(launches)}")
    quarantine.clear()
    faults.clear()
    return launches, seconds, steps


# ---------------------------------------------------------------------------
# explain(analyze=True), the trace, the ledgers and the telemetry's cost
# ---------------------------------------------------------------------------

ANALYZE_COST_RUNS = 15
ANALYZE_SINKS = ("HYPERSPACE_TRACE_FILE", "HYPERSPACE_TIMELINE_DIR", "HYPERSPACE_TRACING", "HYPERSPACE_ACCOUNTING",
                 "HYPERSPACE_DEVICE_TIMING")
#: The C entries each kernel's wrapper calls, by kernel id.
KERNEL_ENTRIES = {"K1": ("hs_bucket_sort",), "K2": ("hs_range_probe_i64", "hs_range_probe_f64"), "K6": ("hs_key64",)}


class EntryCounter:
    """Counts the calls of the kernels' C entries (the launches, seen below
    the wrappers and their registry counts) while installed."""

    def __init__(self, lib):
        self.lib, self.calls, self._orig = lib, {k: 0 for k in KERNEL_ENTRIES}, {}

    def __enter__(self):
        for kid, names in KERNEL_ENTRIES.items():
            for name in names:
                orig = self._orig[name] = getattr(self.lib, name)

                def counted(*args, _orig=orig, _kid=kid):
                    self.calls[_kid] += 1
                    return _orig(*args)

                setattr(self.lib, name, counted)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.lib, name, orig)


def tree_part(text: str) -> list:
    return text.split("\nRule decisions:")[0].splitlines()


def check_annotated(label: str, text: str) -> None:
    """Every operator line of the analyzed tree carries an annotation: its
    measured time and rows, or the mark of a node that did not run; the root
    ran."""
    lines = [ln for ln in tree_part(text) if re.match(r"^\s*(\+- )?[A-Z]\w+", ln)
             and not ln.lstrip().startswith(("EXPLAIN", "query_id", "planning"))]
    if not lines or "[time=" not in lines[0]:
        raise AssertionError(f"{label}: the root line carries no time:\n{text}")
    bare = [ln for ln in lines if "[time=" not in ln and "[not executed" not in ln]
    if bare:
        raise AssertionError(f"{label}: operator lines without an annotation: {bare}")


def phase_analyze(torch, data, base: str, seed: int):
    """`explain(analyze=True)` at the main phase's width in a directory of
    its own: TPC-H Q3 over liQ3 and ordQ3 (the co-bucketed join, value mode:
    K2; then the general join) and TPC-DS Q55 as a star (phase star's
    tables and indexes: hash mode, K1 and K2), each uncached under
    `HYPERSPACE_DEVICE_TIMING=all`: the rows equal collect() with every sink
    off and numpy; every operator line is annotated; the ledger's
    rows_produced is the row count; device_time_s lies in (0, the root's
    wall]; the registry's K1 and K2 counts rose by exactly the calls of
    their C entries. Then `HYPERSPACE_TRACE_FILE` and
    `HYPERSPACE_TIMELINE_DIR`: the JSONL parses, one query_id, and the
    Chrome trace gives each stage its own lane. Last the cost of the
    telemetry: cached Q3's p50 over the same runs with everything off,
    `HYPERSPACE_TRACING=1`, `HYPERSPACE_ACCOUNTING=1` and
    `HYPERSPACE_DEVICE_TIMING=all`, run in turns (prints, not checks)."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.ops import _kernels, cuda_hash, cuda_probe, cuda_sort
    from hyperspace_tpu_torch.plananalysis.analyze import explain_analyze
    from hyperspace_tpu_torch.telemetry import accounting, tracing

    for k in ANALYZE_SINKS:
        os.environ.pop(k, None)
    root = os.path.join(base, "analyze")
    seconds = {}
    s = hst.HyperspaceSession(warehouse=os.path.join(root, "wh"), device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    for src, name, indexed, included in Q3_INDEXES:
        df = s.read.parquet(os.path.join(base, "src", src))
        _, seconds[f"create_{name}"] = wall(lambda: hs.create_index(df, hst.IndexConfig(name, indexed, included)))
    tables, seconds["star_generate"] = wall(lambda: star_tables(np.random.RandomState(seed + 19), SS_ROWS))
    star_root = os.path.join(root, "star")
    _, seconds["star_write"] = wall(lambda: write_star_tables(s, tables, star_root))

    def star_read(t):
        return s.read.parquet(os.path.join(star_root, t))

    for table, name, indexed, included in STAR_INDEXES:
        _, seconds[f"create_{name}"] = wall(lambda: hs.create_index(star_read(table), hst.IndexConfig(
            name, indexed, included)))
    hst.enable_hyperspace(s)
    log(f"[analyze] setup seconds {json.dumps(seconds)}")
    q3 = q3_query(lambda t: s.read.parquet(os.path.join(base, "src", t)), hst.col)
    q55 = star_q55_query(star_read, hst.col)
    want_q3, want_q55 = expected_q3(data), expected_star(tables, "b_q55")

    def check_rows(name, got):
        if name == "q3":
            check_q3("analyze q3", got, want_q3)
        else:
            check_star_rows("analyze q55", got, want_q55)

    lib = _kernels.library()
    totals = {"K1": 0, "K2": 0, "K6": 0}
    for name, df in (("q3", q3), ("q55", q55)):
        clear_caches()
        plain = df.collect().to_numpy()
        check_rows(name, plain)
        clear_caches()
        reset_launches(cuda_sort, cuda_probe, cuda_hash)
        os.environ["HYPERSPACE_DEVICE_TIMING"] = "all"
        try:
            with EntryCounter(lib) as entries:
                (text, result), t_analyze = wall(lambda: explain_analyze(df))
        finally:
            os.environ.pop("HYPERSPACE_DEVICE_TIMING", None)
        got = result.to_numpy()
        check_rows(name, got)
        if list(got) != list(plain) or any(not np.array_equal(got[c], plain[c]) for c in got):
            raise AssertionError(f"analyze {name}: the analyzed rows differ from collect() with every sink off")
        check_annotated(f"analyze {name}", text)
        trace = tracing.last_trace()
        led = accounting.ledger_for(trace.query_id).to_dict()
        if led.get("rows_produced") != result.num_rows:
            raise AssertionError(f"analyze {name}: rows_produced {led.get('rows_produced')} != {result.num_rows}")
        dev_s, wall_s = led.get("device_time_s", 0.0), led["wall_s"]
        if not 0.0 < dev_s <= wall_s:
            raise AssertionError(f"analyze {name}: device_time_s {dev_s} not in (0, wall {wall_s}]")
        reg = registry_launches()
        for kid in KERNEL_ENTRIES:
            if reg[kid] != entries.calls[kid]:
                raise AssertionError(f"analyze {name}: registry {kid} {reg[kid]} != {entries.calls[kid]} calls")
            totals[kid] += reg[kid]
        log(f"[analyze] {name} {json.dumps({'rows': result.num_rows, 'explain_analyze_s': t_analyze, 'wall_s': wall_s, 'device_time_s': dev_s, 'host_time_s': led.get('host_time_s'), 'launches_registry': {k: reg[k] for k in KERNEL_ENTRIES}, 'entry_calls': entries.calls, 'decode_files': led.get('decode_files'), 'bytes_decoded': led.get('bytes_decoded', 0), 'device_upload_bytes': led.get('device_upload_bytes', 0), 'd2h_bytes': led.get('d2h_bytes', 0), 'pad_ratio': led.get('pad_ratio'), 'stages': led.get('stages')})}")
        for line in text.split("\nPlanner:")[0].splitlines():
            log(f"[analyze] {name} | {line}")
    if 0 in totals.values():
        raise AssertionError(f"analyze: K1, K2 and K6 must each launch, got {totals}")

    trace_file, tdir = os.path.join(root, "trace.jsonl"), os.path.join(root, "timelines")
    os.environ["HYPERSPACE_TRACE_FILE"], os.environ["HYPERSPACE_TIMELINE_DIR"] = trace_file, tdir
    try:
        clear_caches()
        q55.collect()
    finally:
        os.environ.pop("HYPERSPACE_TRACE_FILE", None)
        os.environ.pop("HYPERSPACE_TIMELINE_DIR", None)
    with open(trace_file) as fh:
        spans = [json.loads(line) for line in fh]
    qids = {sp["query_id"] for sp in spans}
    ids = {sp["span_id"] for sp in spans}
    if len(qids) != 1 or any(sp["parent_id"] is not None and sp["parent_id"] not in ids for sp in spans):
        raise AssertionError(f"analyze: the JSONL holds {len(qids)} queries or an unresolved parent")
    with open(os.path.join(tdir, f"timeline-{qids.pop()}.json")) as fh:
        doc = json.load(fh)
    lanes = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"] if e["ph"] == "M"}
    stage_lanes = {ln: tid for ln, tid in lanes.items() if ln.startswith("stage:")}
    if len(stage_lanes) < 3 or len(set(stage_lanes.values())) != len(stage_lanes):
        raise AssertionError(f"analyze: the Chrome trace's stage lanes {stage_lanes}")
    by_lane = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X" and e["name"].startswith("join:") and e["name"] != "join:stages":
            by_lane.setdefault(e["tid"], set()).add(e["name"])
    if any(len(names) != 1 for names in by_lane.values()):
        raise AssertionError(f"analyze: a lane holds two stages: {by_lane}")
    log(f"[analyze] trace: {len(spans)} spans, one query; timeline lanes {sorted(lanes)}")

    settings = (("off", None), ("HYPERSPACE_TRACING=1", ("HYPERSPACE_TRACING", "1")),
                ("HYPERSPACE_ACCOUNTING=1", ("HYPERSPACE_ACCOUNTING", "1")),
                ("HYPERSPACE_DEVICE_TIMING=all", ("HYPERSPACE_DEVICE_TIMING", "all")))
    q3.collect()
    seconds_of = {label: [] for label, _ in settings}
    for r in range(ANALYZE_COST_RUNS):  # the settings in turns, each round starting one later
        for label, env in settings[r % 4:] + settings[: r % 4]:
            if env is not None:
                os.environ[env[0]] = env[1]
            try:
                out, t = wall(q3.collect)
            finally:
                if env is not None:
                    os.environ.pop(env[0], None)
            check_q3(f"analyze cost {label}", out.to_numpy(), want_q3)
            seconds_of[label].append(t)
    cost = {label: float(np.median(ts)) for label, ts in seconds_of.items()}
    for label, p50 in cost.items():
        log(f"[analyze] telemetry cost: cached q3 p50 of {ANALYZE_COST_RUNS} with {label}: {p50:.6f} s")
    log(f"[analyze] both queries' analyzed rows equal collect() and numpy; launches {json.dumps(totals)}")
    return totals, seconds, cost



# ---------------------------------------------------------------------------
# The workload history, the metrics exporter, the planner's outcome store and
# profile capture
# ---------------------------------------------------------------------------

HISTORY_RUNS = 10
HISTORY_COST_RUNS = 15
HISTORY_HANG = "io.decode:1:hang2:1"
HISTORY_WINDOW_S = "3"
HISTORY_ENVS = ("HYPERSPACE_HISTORY", "HYPERSPACE_HISTORY_DIR", "HYPERSPACE_METRICS_FILE",
                "HYPERSPACE_METRICS_INTERVAL_S", "HYPERSPACE_PROFILE_DIR", "HYPERSPACE_PROFILE_WINDOW_S",
                "HYPERSPACE_PROFILE_MIN_INTERVAL_S", "HYPERSPACE_DEVICE_TIMING", "HYPERSPACE_PLANNER_MIN_SAMPLES",
                "HYPERSPACE_TRACING", "HYPERSPACE_FAULTS", "HYPERSPACE_MULTIWAY")
#: The `__global__` names of K1 (`csrc/bucket_sort.cu`) and K2
#: (`csrc/range_probe.cu`) as a profiler's kernel events name them.
K1_GLOBALS, K2_GLOBALS = ("sort_tiles", "merge_runs"), ("windowed_probe",)

#: The child of step (c): another process opens the same directories and
#: prints what it folds. It imports nothing of the JAX package.
HISTORY_CHILD = """
import json, os, sys
sys.path.insert(0, sys.argv[1])
from hyperspace_tpu_torch.plananalysis import planner
from hyperspace_tpu_torch.telemetry import history
assert not any(m == "jax" or m.startswith("jax.") or m.split(".")[0] == "hyperspace_tpu" for m in sys.modules)
fields = ("rows_produced", "decode_files", "bytes_decoded")
base = {fp: [b["n"]] + [b.get(f) for f in fields] for fp, b in history.get_store().baselines().items()}
out = {fp: [v["n"]] for fp, v in ((json.dumps(k), v) for k, v in planner.outcome_summary().items())}
print(json.dumps({"baselines": base, "outcomes": out}))
"""


def card_check(ok: bool, msg: str) -> None:
    """A check of what only a card can show (kernel launches, CUDA events,
    CUDA kernels in a profile, live device bytes)."""
    if not ok:
        raise AssertionError(msg)


def same_answer(label: str, got: dict, want: dict) -> None:
    """`got` equals `want` column by column: exactly, float columns at rtol
    1e-12 (the chunk arms' last bits)."""
    if list(got) != list(want) or any(len(got[c]) != len(want[c]) for c in want):
        raise AssertionError(f"{label}: columns or rows differ from the answer with everything off")
    for c in want:
        a, b = np.asarray(got[c]), np.asarray(want[c])
        ok = np.allclose(a, b, rtol=1e-12, atol=0) if a.dtype.kind == "f" else np.array_equal(a, b)
        if not ok:
            raise AssertionError(f"{label}: {c} differs from the answer with everything off")


def phase_history(torch, data, base: str, seed: int, ss_rows: int = SS_ROWS):
    """The history slice at the main phase's width, in a directory of its
    own: TPC-H Q3 over liQ3 and ordQ3 (K2) and TPC-DS Q55 as a star over
    phase star's tables (K1 and K2), the planner at its default.
    (a) Each query once with everything off, then `HYPERSPACE_HISTORY=1`, a
    history and a profile directory, the exporter (`HYPERSPACE_METRICS_FILE`,
    0.5 s frames) and `HYPERSPACE_DEVICE_TIMING=all`: each query uncached
    HISTORY_RUNS times in turns; every answer equals numpy's and the one with
    everything off; `history.records` rose by the queries run; the store holds
    one baseline a class with HISTORY_RUNS samples; Q55's has device seconds.
    (b) One more uncached Q3 under `HISTORY_HANG`, traced: `history.anomalies`
    ticks once, the root span carries `history_anomaly`, a capture directory
    names the query; once its profiler window has started, Q55 runs in it
    (the star pinned, so K1 and K2 launch whatever the outcome store
    learned) and the window's Chrome trace names K1's and K2's kernels. (c) A child process folds the same
    directories to the same baselines and outcome keys. (d) The exporter's
    final frame, every line parsing, live device bytes, the Prometheus names
    of K1's and K2's launch counters. (e) Prints: the planner over a warm
    aggregate repeated 8 times (`HYPERSPACE_PLANNER_MIN_SAMPLES=2`), and
    cached Q3's p50 with everything off, with history on and with the
    exporter running, in turns (and, to split history's cost, with the
    ledger alone and with history but the planner off)."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort
    from hyperspace_tpu_torch.plananalysis import planner
    from hyperspace_tpu_torch.telemetry import accounting, exporter, faults, history, metrics, tracing
    from hyperspace_tpu_torch.telemetry import device_observatory as dv

    for k in HISTORY_ENVS:
        os.environ.pop(k, None)
    root = os.path.join(base, "history")
    seconds = {}
    s = hst.HyperspaceSession(warehouse=os.path.join(root, "wh"), device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    for src, name, indexed, included in Q3_INDEXES:
        df = s.read.parquet(os.path.join(base, "src", src))
        _, seconds[f"create_{name}"] = wall(lambda: hs.create_index(df, hst.IndexConfig(name, indexed, included)))
    tables, seconds["star_generate"] = wall(lambda: star_tables(np.random.RandomState(seed + 23), ss_rows))
    star_root = os.path.join(root, "star")
    _, seconds["star_write"] = wall(lambda: write_star_tables(s, tables, star_root))

    def star_read(t):
        return s.read.parquet(os.path.join(star_root, t))

    for table, name, indexed, included in STAR_INDEXES:
        _, seconds[f"create_{name}"] = wall(lambda: hs.create_index(star_read(table), hst.IndexConfig(
            name, indexed, included)))
    hst.enable_hyperspace(s)
    log(f"[history] setup seconds {json.dumps(seconds)}")
    queries = {"q3": q3_query(lambda t: s.read.parquet(os.path.join(base, "src", t)), hst.col),
               "q55": star_q55_query(star_read, hst.col)}
    want = {"q3": expected_q3(data), "q55": expected_star(tables, "b_q55")}

    def check(name, label, got):
        if name == "q3":
            check_q3(f"history {label}", got, want["q3"])
        else:
            check_star_rows(f"history {label}", got, want["q55"])

    plain = {}
    for name, df in queries.items():
        clear_caches()
        plain[name] = df.collect().to_numpy()
        check(name, f"{name} off", plain[name])

    hist_dir, prof_dir = os.path.join(root, "hist"), os.path.join(root, "prof")
    frames_path = os.path.join(root, "metrics.jsonl")
    os.environ.update({"HYPERSPACE_HISTORY": "1", "HYPERSPACE_HISTORY_DIR": hist_dir,
                       "HYPERSPACE_METRICS_FILE": frames_path, "HYPERSPACE_METRICS_INTERVAL_S": "0.5",
                       "HYPERSPACE_PROFILE_DIR": prof_dir, "HYPERSPACE_PROFILE_WINDOW_S": HISTORY_WINDOW_S,
                       "HYPERSPACE_PROFILE_MIN_INTERVAL_S": "0", "HYPERSPACE_DEVICE_TIMING": "all"})
    try:
        if not exporter.start():
            raise AssertionError("history: the exporter did not start from HYPERSPACE_METRICS_FILE")
        # (a) the baselines
        reset_launches(cuda_sort, cuda_probe, cuda_hash)
        records0 = metrics.counter("history.records").value
        anomalies0 = metrics.counter("history.anomalies").value
        fps, walls, arms = {}, {n: [] for n in queries}, {n: [] for n in queries}
        for r in range(HISTORY_RUNS):
            for name, df in queries.items():
                clear_caches()
                out, t = wall(df.collect)
                got = out.to_numpy()
                check(name, f"{name} run {r}", got)
                same_answer(f"history {name} run {r}", got, plain[name])
                led = accounting.recent_ledgers()[-1].to_dict()
                fps.setdefault(name, led["plan_fingerprint"])
                if led["plan_fingerprint"] != fps[name]:
                    raise AssertionError(f"history {name}: run {r} planned another class")
                walls[name].append(round(led["wall_s"], 4))
                arms[name].append({k: f"{d.arm}/{d.source}" for k, d in planner.last_decisions().decisions.items()
                                   if d.source != "model"})
        launches = {kid: n for kid, n in registry_launches().items() if kid in ("K1", "K2", "K6")}
        records = metrics.counter("history.records").value - records0
        if records != 2 * HISTORY_RUNS:
            raise AssertionError(f"history: history.records rose by {records}, want {2 * HISTORY_RUNS}")
        store = history.get_store()
        baselines = store.baselines()
        if set(baselines) != set(fps.values()) or any(baselines[fp]["n"] != HISTORY_RUNS for fp in fps.values()):
            raise AssertionError(f"history: baselines {({fp: b['n'] for fp, b in baselines.items()})}, want "
                                 f"{HISTORY_RUNS} for each of {fps}")
        card_check(baselines[fps["q55"]].get("device_time_s", 0) > 0, "history: Q55's baseline has no device seconds")
        card_check(launches["K1"] > 0 and launches["K2"] > 0, f"history (a): K1 and K2 must launch, got {launches}")
        baseline_anomalies = metrics.counter("history.anomalies").value - anomalies0
        for name in queries:
            b = baselines[fps[name]]
            log(f"[history] (a) {name} {json.dumps({'fingerprint': fps[name], 'walls_s': walls[name], 'n': b['n'], 'wall_p50_s': b.get('wall_p50_s'), 'wall_mean_s': b['wall_mean_s'], 'wall_std_s': b['wall_std_s'], 'device_time_s': b.get('device_time_s', 0), 'rows_produced': b.get('rows_produced'), 'decode_files': b.get('decode_files'), 'bytes_decoded': b.get('bytes_decoded')})}")
            log(f"[history] (a) {name} planner arms off the model, by run: {json.dumps(arms[name])}")
        log(f"[history] (a) launches {json.dumps(launches)}; anomalies while the "
            f"baselines formed: {baseline_anomalies}")

        # (b) one anomaly, its capture, and a profiler window over Q55
        if dv._trace_thread[0] is not None:
            dv._trace_thread[0].join(timeout=60)  # a baseline anomaly's window
        faults.reset_counters()
        os.environ.update({"HYPERSPACE_FAULTS": HISTORY_HANG, "HYPERSPACE_TRACING": "1"})
        anomalies1 = metrics.counter("history.anomalies").value
        try:
            clear_caches()
            out, t_hang = wall(queries["q3"].collect)
        finally:
            for k in ("HYPERSPACE_FAULTS", "HYPERSPACE_TRACING"):
                os.environ.pop(k, None)
        check("q3", "q3 under the hang", out.to_numpy())
        same_answer("history q3 under the hang", out.to_numpy(), plain["q3"])
        if metrics.counter("history.anomalies").value - anomalies1 != 1:
            raise AssertionError(f"history (b): history.anomalies rose by "
                                 f"{metrics.counter('history.anomalies').value - anomalies1}, want 1")
        verdict = tracing.last_trace().root.attrs.get("history_anomaly")
        if not verdict or verdict.get("fingerprint") != fps["q3"]:
            raise AssertionError(f"history (b): the root span's history_anomaly is {verdict}")
        cap_dir = os.path.join(prof_dir, "capture")
        with open(os.path.join(cap_dir, "capture.json")) as fh:
            manifest = json.load(fh)
        captures = sorted(n for n in os.listdir(prof_dir) if n.startswith("capture"))
        if manifest["detail"].get("query_id") != verdict["query_id"] or len(captures) != 1 + baseline_anomalies:
            raise AssertionError(f"history (b): captures {captures}, manifest {manifest['detail']}")
        if not dv._trace_started.wait(timeout=120):
            raise AssertionError("history (b): the capture's profiler window did not start")
        os.environ["HYPERSPACE_MULTIWAY"] = "1"
        try:
            reset_launches(cuda_sort, cuda_probe, cuda_hash)
            clear_caches()
            out, t_window = wall(queries["q55"].collect)
        finally:
            os.environ.pop("HYPERSPACE_MULTIWAY", None)
        window_launches = registry_launches()
        check("q55", "q55 in the window", out.to_numpy())
        same_answer("history q55 in the window", out.to_numpy(), plain["q55"])
        dv._trace_thread[0].join(timeout=120)
        with open(os.path.join(cap_dir, "trace.json")) as fh:
            status = json.load(fh)
        kernel_names = set()
        if status.get("trace"):
            with open(os.path.join(cap_dir, status["chrome_trace"])) as fh:
                kernel_names = {e.get("name", "") for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel"}
        k1_seen = sorted({g for g in K1_GLOBALS for n in kernel_names if g in n})
        k2_seen = sorted({g for g in K2_GLOBALS for n in kernel_names if g in n})
        log(f"[history] (b) hang {HISTORY_HANG}: q3 {t_hang:.4f} s; verdict {json.dumps(verdict)}; q55 in the "
            f"window {t_window:.4f} s, K1 {window_launches['K1']} / K2 {window_launches['K2']} launches; trace "
            f"{json.dumps(status)}; {len(kernel_names)} kernel names, K1 {k1_seen}, K2 {k2_seen}")
        card_check(status.get("trace") is True and "CUDA" in status.get("activities", []),
                   f"history (b): the window did not trace the card: {status}")
        card_check(bool(k1_seen) and bool(k2_seen), f"history (b): the window's trace names K1 {k1_seen}, K2 "
                                                    f"{k2_seen} among {sorted(kernel_names)[:20]}")
        for kid in ("K1", "K2"):
            launches[kid] += window_launches[kid]

        # (c) another process reads the same directories
        env = {k: v for k, v in os.environ.items() if k not in ("HYPERSPACE_METRICS_FILE", "HYPERSPACE_PROFILE_DIR")}
        child = subprocess.run([sys.executable, "-c", HISTORY_CHILD, os.path.dirname(os.path.abspath(__file__))],
                               env=env, capture_output=True, text=True, timeout=300)
        if child.returncode != 0:
            raise AssertionError(f"history (c): the child failed: {child.stderr[-3000:]}")
        seen = json.loads(child.stdout.strip().splitlines()[-1])
        mine = {fp: [b["n"]] + [b.get(f) for f in ("rows_produced", "decode_files", "bytes_decoded")]
                for fp, b in history.get_store().baselines().items()}
        if seen["baselines"] != mine:
            raise AssertionError(f"history (c): the child folds {seen['baselines']}, this process {mine}")
        outcomes = {json.dumps(list(k)): [v["n"]] for k, v in planner.outcome_summary().items()}
        if seen["outcomes"] != outcomes:
            raise AssertionError(f"history (c): the child's outcome summary {seen['outcomes']} != {outcomes}")
        log(f"[history] (c) a child folds the same {len(mine)} baselines and {len(outcomes)} outcome keys")
    finally:
        exporter.stop()
        for k in HISTORY_ENVS:
            os.environ.pop(k, None)

    # (d) the exporter's stream
    with open(frames_path) as fh:
        frames = [json.loads(line) for line in fh]
    if not frames or frames[-1].get("final") is not True:
        raise AssertionError("history (d): the exporter's last frame is not final")
    named = [a for fr in frames for a in (fr.get("history") or {}).get("anomalies", [])
             if a.get("query_id") == verdict["query_id"]]
    if len(named) != 1:
        raise AssertionError(f"history (d): {len(named)} frames name the anomaly")
    live = max(fr.get("device_live_bytes", 0) for fr in frames)
    card_check(live > 0, "history (d): no frame carries device_live_bytes")
    prom = exporter.prometheus_text()
    prom_names = [exporter._prom_name(f"kernel.launches.{m.LABEL}") for m in (cuda_sort, cuda_probe)]
    missing = [n for n in prom_names if f"# TYPE hyperspace_{n} counter" not in prom]
    if missing:
        raise AssertionError(f"history (d): the Prometheus text lacks {missing}")
    log(f"[history] (d) {len(frames)} frames, the last final; peak device_live_bytes {live}; Prometheus names "
        f"{prom_names}")

    # (e) prints: the planner learning on a warm aggregate, and the cost
    os.environ.update({"HYPERSPACE_PLANNER_DIR": os.path.join(root, "planner-warm"),
                       "HYPERSPACE_PLANNER_MIN_SAMPLES": "2"})
    try:
        agg = star_store_query(star_read)
        want_agg = expected_store_agg(tables["store_sales"])
        planner.reset()
        agg.collect()  # warms the footers and the caches
        learned = []
        for r in range(8):
            out, t = wall(agg.collect)
            check_store_agg(f"history warm aggregate {r}", out.to_numpy(), want_agg)
            pd = planner.last_decisions()
            learned.append([round(t, 4), {k: f"{d.arm}/{d.source}" for k, d in pd.decisions.items()
                                          if d.source != "model"}])
        log(f"[history] (e) warm aggregate x8 (seconds, arms off the model): {json.dumps(learned)}")
        log(f"[history] (e) activity {json.dumps(planner.activity_summary())}")
    finally:
        for k in ("HYPERSPACE_PLANNER_DIR", "HYPERSPACE_PLANNER_MIN_SAMPLES"):
            os.environ.pop(k, None)
        planner.reset()
    # The three ways the slice adds, and two that split history's cost: the
    # ledger alone, and history with the planner (and so its learning) off.
    settings = {"off": {}, "HYPERSPACE_ACCOUNTING=1": {"HYPERSPACE_ACCOUNTING": "1"},
                "HYPERSPACE_HISTORY=1 HYPERSPACE_PLANNER=0": {"HYPERSPACE_PLANNER": "0"},
                "HYPERSPACE_HISTORY=1": {}, "exporter": {}}
    labels = list(settings)
    q3 = queries["q3"]
    q3.collect()
    seconds_of = {label: [] for label in labels}
    learned_arms = []
    for r in range(HISTORY_COST_RUNS):
        for label in labels[r % len(labels):] + labels[: r % len(labels)]:
            env = dict(settings[label])
            if label.startswith("HYPERSPACE_HISTORY=1"):
                env.update({"HYPERSPACE_HISTORY": "1", "HYPERSPACE_HISTORY_DIR": os.path.join(root, "cost")})
            os.environ.update(env)
            if label == "exporter":
                exporter.start(os.path.join(root, "cost.jsonl"), 0.5)
            try:
                out, t = wall(q3.collect)
            finally:
                for k in env:
                    os.environ.pop(k, None)
                exporter.stop()
            if label == "HYPERSPACE_HISTORY=1":
                learned_arms.append({k: f"{d.arm}/{d.source}" for k, d in planner.last_decisions().decisions.items()
                                     if d.source != "model"})
            check_q3(f"history cost {label}", out.to_numpy(), want["q3"])
            seconds_of[label].append(t)
    planner.reset()
    log(f"[history] cost: the learning planner's arms off the model, by run: {json.dumps(learned_arms)}")
    history.reset_stores()
    cost = {label: float(np.median(ts)) for label, ts in seconds_of.items()}
    for label, p50 in cost.items():
        log(f"[history] cost: cached q3 p50 of {HISTORY_COST_RUNS} with {label}: {p50:.6f} s")
    return launches, seconds, cost


SERVE_INDEXES = Q3_INDEXES + INDEXES  # Q3's, q3_agg's (liOrd, ordIdx) and Q9's join (liPs, psIdx)
SERVE_LOOKUPS = 48  # interactive point lookups
SERVE_BATCH = 16  # batch Q3 / Q9 join / q3_agg collects
SERVE_TENANTS = 4
SERVE_WORKERS = 4
SERVE_FLIGHT = 8  # identical cold Q3 collects
SERVE_ENVS = ("HYPERSPACE_REPLICAS", "HYPERSPACE_REPLICA_DIR")


def digest(cols: dict) -> str:
    """sha256 of a `to_numpy()` result: its column names, dtypes and bytes
    (an object column by its values' reprs)."""
    h = hashlib.sha256()
    for name, arr in cols.items():
        arr = np.asarray(arr)
        h.update(f"{name}:{arr.dtype}:{len(arr)}".encode())
        h.update(repr(arr.tolist()).encode() if arr.dtype.kind == "O" else np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def serve_queries(s, hst, base: str) -> dict:
    """The served queries of phase serve over a session with its indexes."""

    def rd(t):
        return s.read.parquet(os.path.join(base, "src", t))

    return {"q3": q3_query(rd, hst.col), "q9_join": queries(s, base)["q_ps"], "q3_agg": q3_agg(s, base)}


def serve_lookup(s, hst, base: str, key: int):
    """A point lookup of one order's lines: FilterIndexRule over the
    l_orderkey indexes, one bucket file."""
    return s.read.parquet(os.path.join(base, "src", "lineitem")).filter(hst.col("l_orderkey") == int(key)).select(
        "l_orderkey", "l_extendedprice", "l_discount")


def lookup_file(df) -> str:
    """The one index file a lookup reads: its fleet routing key."""
    rel = index_scan(df)
    if rel is None or len(rel.files) != 1:
        raise AssertionError(f"serve: a lookup does not read one index file:\n{df.explain_string()}")
    return rel.files[0].path


SERVE_CHILD = """
import json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import chip_smoke as cs
import hyperspace_tpu_torch as hst
from hyperspace_tpu_torch.engine import io as engine_io
from hyperspace_tpu_torch.serve import replicas
from hyperspace_tpu_torch.telemetry import metrics
assert not any(m == "jax" or m.startswith("jax.") or m.split(".")[0] == "hyperspace_tpu" for m in sys.modules)
warehouse, base, device = sys.argv[2], sys.argv[3], sys.argv[4]
s = hst.HyperspaceSession(warehouse=warehouse, device=device)
s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, cs.NUM_BUCKETS)
hs = hst.Hyperspace(s)
hst.enable_hyperspace(s)
srv = hs.server(max_concurrent=2)
q3 = cs.serve_queries(s, hst, base)["q3"]
print(json.dumps({"ready": replicas.replica_id()}), flush=True)
for line in sys.stdin:
    cmd = json.loads(line)
    out = {}
    if cmd["cmd"] in ("q3", "lookups"):
        cs.clear_caches()
        d0 = engine_io.io_stats()["decode_files"]
        if cmd["cmd"] == "q3":
            out["digest"] = cs.digest(srv.run(q3.collect, tenant="child").to_numpy())
        else:
            taken = {}
            for k, path in cmd["files"].items():
                if replicas.owns(path):
                    df = cs.serve_lookup(s, hst, base, int(k))
                    if cs.lookup_file(df) != path:
                        raise AssertionError(f"the lookup of {k} reads {cs.lookup_file(df)}, not {path}")
                    taken[k] = cs.digest(srv.run(df.collect, tenant="child", lane="interactive").to_numpy())
            out["digests"] = taken
        out["decode_files"] = engine_io.io_stats()["decode_files"] - d0
        if device == "cuda":
            import torch
            out["device_bytes"] = torch.cuda.memory_allocated()
            out["device_peak_bytes"] = torch.cuda.max_memory_allocated()
    elif cmd["cmd"] == "entry":
        entry = next(e for e in hs._manager.get_indexes() if e.name == cmd["name"])
        out = {"id": entry.id, "observed": metrics.counter("replicas.invalidations.observed").value}
    elif cmd["cmd"] == "exit":
        srv.close()
        replicas.leave_fleet()
        print(json.dumps({"bye": True}), flush=True)
        break
    print(json.dumps(out), flush=True)
"""


def serve_latencies(srv, jobs) -> tuple:
    """Submit `jobs` (name, lane, tenant, thunk) in order, all at once; wait
    for each. (outputs as numpy dicts, seconds from each submission to its
    result, the wall from the first submission to the last result)."""
    done = {}
    t0 = time.perf_counter()
    futs = []
    for i, (_, lane, tenant, fn) in enumerate(jobs):
        t_sub = time.perf_counter()
        fut = srv.submit(fn, tenant=tenant, lane=lane)
        fut.add_done_callback(lambda f, i=i, t_sub=t_sub: done.__setitem__(i, time.perf_counter() - t_sub))
        futs.append(fut)
    outs = [f.result(600).to_numpy() for f in futs]
    return outs, [done[i] for i in range(len(jobs))], time.perf_counter() - t0


def phase_serve(torch, data, base: str, seed: int):
    """The serving layer and the replica fleet at SF1, in a directory of its
    own: liQ3 and ordQ3 (Q3), liOrd and ordIdx (q3_agg), liPs and psIdx
    (Q9's join: hash mode, K1 then K2).
    (1) Serial answers: Q3 (value mode, K2) and q3_agg against numpy, Q9's
    join against a numpy join, and SERVE_LOOKUPS point lookups
    (`l_orderkey == k`, keys drawn from `RandomState(seed)` over the orders,
    FilterIndexRule on one bucket file) against numpy.
    (2) `hs.server(max_concurrent=SERVE_WORKERS)`, SERVE_TENANTS tenants,
    caches emptied before each run: the lookups alone (interactive lane);
    the lookups and SERVE_BATCH batch collects (Q3, Q9's join, q3_agg in
    turn) in a seeded interleaving; both again at max_concurrent 1,
    and at SERVE_WORKERS with `HYPERSPACE_SERVE_GIL_SWITCH_S=0` and
    `HYPERSPACE_SERVE_BATCH_NICE=0` (the interpreter's switch interval and
    the workers' priority left alone). Every served answer equals its
    serial answer (rows and order, exactly).
    Prints the lookups' p50 / p99 from submission to result, alone and
    under the batch load, the throughput at 1 and SERVE_WORKERS workers, and
    the phase's K1 and K2 launches (both above 0).
    (3) Single flight: SERVE_FLIGHT identical cold Q3 collects decode as
    many files (`io_stats()["decode_files"]`) as one cold Q3.
    (4) The fleet (`HYPERSPACE_REPLICAS=1`, a registry of its own): a child
    process importing only the port joins as a second replica; both answer
    Q3 with the same rows; each replica runs the lookups whose index file
    it owns (`serve.replicas.owns`), both at once, and the two decode counts
    sum to one cold run's; `refresh_index("ordQ3")` here flips the child's index cache
    through the epoch file at once (its default TTL is 300 s); the child
    exits cleanly. Prints each replica's device bytes."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort
    from hyperspace_tpu_torch.serve import replicas
    from hyperspace_tpu_torch.telemetry import metrics

    for k in SERVE_ENVS:
        os.environ.pop(k, None)
    reset_launches(cuda_sort, cuda_probe, cuda_hash)
    root = os.path.join(base, "serve")
    warehouse = os.path.join(root, "wh")
    s = hst.HyperspaceSession(warehouse=warehouse, device=DEVICE)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace(s)
    seconds = {}
    for src, name, indexed, included in SERVE_INDEXES:
        df = s.read.parquet(os.path.join(base, "src", src))
        _, seconds[f"create_{name}"] = wall(lambda: hs.create_index(df, hst.IndexConfig(name, indexed, included)))
    hst.enable_hyperspace(s)
    log(f"[serve] build seconds {json.dumps(seconds)}")

    # (1) serial answers
    batch = serve_queries(s, hst, base)
    rng = np.random.RandomState(seed)
    keys = [int(k) for k in rng.choice(data["orders"]["o_orderkey"], SERVE_LOOKUPS, replace=False)]
    lookups = {k: serve_lookup(s, hst, base, k) for k in keys}
    li = data["lineitem"]
    want_ps = canonical(expected_rows(data)[1])
    clear_caches()
    serial = {}
    for name, df in batch.items():
        serial[name] = df.collect().to_numpy()
    check_q3("serve serial q3", serial["q3"], expected_q3(data))
    if not same_multiset(serial["q9_join"], want_ps):
        raise AssertionError("serve: Q9's join differs from the numpy join")
    check_q3_agg(serial["q3_agg"], expected_q3_agg(data))
    files, lookup_s = {}, []
    for k, df in lookups.items():
        files[k] = lookup_file(df)
        t0 = time.perf_counter()
        serial[k] = df.collect().to_numpy()
        lookup_s.append(time.perf_counter() - t0)
        rows = np.nonzero(li["l_orderkey"] == k)[0]
        want = canonical({"l_orderkey": li["l_orderkey"][rows], "l_extendedprice": li["l_extendedprice"][rows],
                          "l_discount": li["l_discount"][rows]})
        if not same_multiset(serial[k], want):
            raise AssertionError(f"serve: the lookup of order {k} differs from numpy")
    log(f"[serve] (1) serial answers equal numpy: Q3, Q9's join ({len(serial['q9_join']['l_quantity'])} rows), "
        f"q3_agg, {len(keys)} lookups over {len(set(files.values()))} index files; a lookup alone, first run, "
        f"p50 {np.median(lookup_s):.6f} s, max {max(lookup_s):.6f} s")

    # (2) mixed traffic
    def job(i, name):
        if name in batch:
            return (name, "batch", f"tenant{i % SERVE_TENANTS}", batch[name].collect)
        return (name, "interactive", f"tenant{i % SERVE_TENANTS}", lookups[name].collect)

    alone = [job(i, k) for i, k in enumerate(keys)]
    order = list(keys) + [list(batch)[i % len(batch)] for i in range(SERVE_BATCH)]
    mixed = [job(i, n) for i, n in enumerate(np.random.RandomState(seed + 1).permutation(np.array(order, object)))]

    switch = sys.getswitchinterval()

    def served(jobs, workers, env=None):
        clear_caches()
        os.environ.update(env or {})
        if env:
            sys.setswitchinterval(switch)  # the server lowers it only when asked
        with hs.server(max_concurrent=workers) as srv:
            outs, lat, total = serve_latencies(srv, jobs)
        for (name, _, _, _), out in zip(jobs, outs):
            if list(out) != list(serial[name]) or any(
                    not np.array_equal(np.asarray(out[c]), np.asarray(serial[name][c])) for c in out):
                raise AssertionError(f"serve: the served {name} differs from its serial answer")
        inter = [t for (name, lane, _, _), t in zip(jobs, lat) if lane == "interactive"]
        return {"interactive_p50_s": float(np.percentile(inter, 50)), "interactive_p99_s": float(np.percentile(inter, 99)),
                "queries": len(jobs), "wall_s": total, "queries_per_s": len(jobs) / total}

    results = {"alone": served(alone, SERVE_WORKERS), "alone_1_worker": served(alone, 1),
               "mixed": served(mixed, SERVE_WORKERS), "mixed_1_worker": served(mixed, 1)}
    # The same traffic with the interpreter's switch interval and the batch
    # workers' priority left as they were: what the two host knobs do.
    knobs = {"HYPERSPACE_SERVE_GIL_SWITCH_S": "0", "HYPERSPACE_SERVE_BATCH_NICE": "0"}
    try:
        results["mixed_knobs_off"] = served(mixed, SERVE_WORKERS, knobs)
    finally:
        for k in knobs:
            os.environ.pop(k, None)
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    card_check(launches["K1"] > 0 and launches["K2"] > 0, f"serve (2): K1 and K2 must launch, got {launches}")
    log(f"[serve] (2) {nvidia_smi_line()}: every served answer equals its serial answer; "
        f"{json.dumps(results)}; launches so far {json.dumps(launches)}")

    # (3) single flight
    clear_caches()
    d0 = engine_io.io_stats()["decode_files"]
    _, t_one = wall(batch["q3"].collect)
    one_cold = engine_io.io_stats()["decode_files"] - d0
    clear_caches()
    before = {n: metrics.counter(n).value for n in ("serve.singleflight.dedup_hits", "serve.singleflight.leaders")}
    d0 = engine_io.io_stats()["decode_files"]
    with hs.server(max_concurrent=SERVE_WORKERS) as srv:
        outs, lat, total = serve_latencies(srv, [("q3", "interactive", f"tenant{i % SERVE_TENANTS}",
                                                  batch["q3"].collect) for i in range(SERVE_FLIGHT)])
    flight = engine_io.io_stats()["decode_files"] - d0
    if any(digest(o) != digest(serial["q3"]) for o in outs):
        raise AssertionError("serve (3): a deduplicated Q3 differs from its serial answer")
    if flight != one_cold:
        raise AssertionError(f"serve (3): {SERVE_FLIGHT} identical cold Q3s decoded {flight} files, one cold run "
                             f"{one_cold}")
    deltas = {n: metrics.counter(n).value - v for n, v in before.items()}
    log(f"[serve] (3) {SERVE_FLIGHT} identical cold Q3 collects decoded {flight} files = one cold Q3's {one_cold} "
        f"({t_one:.4f} s alone); {total:.4f} s for the {SERVE_FLIGHT}; {json.dumps(deltas)}")

    # (4) the fleet
    registry = os.path.join(root, "registry")
    os.environ.update({"HYPERSPACE_REPLICAS": "1", "HYPERSPACE_REPLICA_DIR": registry})
    clear_caches()
    d0 = engine_io.io_stats()["decode_files"]
    t0 = time.perf_counter()
    for k, df in lookups.items():
        df.collect()
    t_one_process = time.perf_counter() - t0
    lookups_cold = engine_io.io_stats()["decode_files"] - d0
    err_path = os.path.join(root, "child.err")
    with open(err_path, "w") as err:
        child = subprocess.Popen(
            [sys.executable, "-c", SERVE_CHILD, os.path.dirname(os.path.abspath(__file__)), warehouse, base, DEVICE],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, text=True, env=dict(os.environ))

    def child_err() -> str:
        with open(err_path) as fh:
            return fh.read()[-3000:]

    def tell(cmd: dict) -> None:
        child.stdin.write(json.dumps(cmd) + "\n")
        child.stdin.flush()

    def answer() -> dict:
        line = child.stdout.readline()
        if not line:
            raise AssertionError(f"serve (4): the child died: {child_err()}")
        return json.loads(line)

    def ask(cmd: dict) -> dict:
        tell(cmd)
        return answer()

    try:
        t0 = time.perf_counter()
        ready = json.loads(child.stdout.readline() or "{}")
        if "ready" not in ready:
            raise AssertionError(f"serve (4): the child did not start: {child_err()}")
        with hs.server(max_concurrent=SERVE_WORKERS) as srv:
            me, peer = replicas.replica_id(), ready["ready"]
            deadline = time.monotonic() + 60
            while set(replicas.live_replicas(refresh=True)) != {me, peer}:
                if time.monotonic() > deadline:
                    raise AssertionError(f"serve (4): the registry lists {replicas.live_replicas(refresh=True)}")
                time.sleep(0.05)
            t_ready = time.perf_counter() - t0
            members = replicas.live_replicas()
            clear_caches()
            mine_q3 = digest(srv.run(batch["q3"].collect, tenant="parent").to_numpy())
            theirs = ask({"cmd": "q3"})
            if not mine_q3 == theirs["digest"] == digest(serial["q3"]):
                raise AssertionError("serve (4): the replicas' Q3 rows differ")
            owner = {k: replicas.owner_of(files[k], members) for k in keys}
            clear_caches()
            d0 = engine_io.io_stats()["decode_files"]
            mine = {}
            t0 = time.perf_counter()
            tell({"cmd": "lookups", "files": {str(k): files[k] for k in keys}})  # both serve their shares at once
            for k in keys:
                if replicas.owns(files[k]):
                    mine[k] = digest(srv.run(lookups[k].collect, tenant="parent", lane="interactive").to_numpy())
            mine_decodes = engine_io.io_stats()["decode_files"] - d0
            theirs = answer()
            t_fleet = time.perf_counter() - t0
            taken = {int(k): d for k, d in theirs["digests"].items()}
            if sorted(mine) != sorted(k for k in keys if owner[k] == me) or sorted(taken) != sorted(
                    k for k in keys if owner[k] == peer):
                raise AssertionError("serve (4): the replicas did not split the lookups by owner_of")
            if any(d != digest(serial[k]) for part in (mine, taken) for k, d in part.items()):
                raise AssertionError("serve (4): a routed lookup differs from its serial answer")
            if mine_decodes + theirs["decode_files"] != lookups_cold:
                raise AssertionError(f"serve (4): the replicas decoded {mine_decodes} + {theirs['decode_files']} "
                                     f"files, one cold run {lookups_cold}")
            before_entry = ask({"cmd": "entry", "name": "ordQ3"})
            _, t_refresh = wall(lambda: hs.refresh_index("ordQ3", "full"))
            latest = next(e.id for e in hs._manager.get_indexes() if e.name == "ordQ3")
            t_flip = time.perf_counter()
            after_entry = ask({"cmd": "entry", "name": "ordQ3"})
            t_flip = time.perf_counter() - t_flip
            if not (after_entry["id"] == latest > before_entry["id"]) or after_entry["observed"] <= before_entry[
                    "observed"]:
                raise AssertionError(f"serve (4): the child saw ordQ3 {before_entry} then {after_entry}, the "
                                     f"latest id is {latest}")
            parent_bytes = torch.cuda.memory_allocated() if DEVICE == "cuda" else None
            bye = ask({"cmd": "exit"})
            child.wait(timeout=60)
            if child.returncode != 0 or not bye.get("bye"):
                raise AssertionError(f"serve (4): the child exited {child.returncode}: {child_err()}")
        log(f"[serve] (4) {nvidia_smi_line()}: a second replica ready in {t_ready:.2f} s; Q3 equal in both; lookups "
            f"split {len(mine)} here / {len(taken)} there, decoding {mine_decodes} + {theirs['decode_files']} files "
            f"= one cold run's {lookups_cold}; the 48 cold lookups in {t_fleet:.4f} s across the two replicas "
            f"(the child clears its caches first), {t_one_process:.4f} s in one process alone; refresh_index(ordQ3) "
            f"{t_refresh:.4f} s, the child saw entry "
            f"{before_entry['id']} -> {after_entry['id']} in {t_flip:.4f} s; device bytes: this replica "
            f"{parent_bytes}, the child {theirs.get('device_bytes')} (peak {theirs.get('device_peak_bytes')})")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
        replicas.leave_fleet()
        for k in SERVE_ENVS:
            os.environ.pop(k, None)
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    log(f"[serve] launches {json.dumps(launches)}")
    return launches, seconds, results


KERNEL_META = {
    "K1": ("bucket_sort", "hyperspace_tpu_torch/csrc/bucket_sort.cu", "hyperspace_tpu/ops/pallas_sort.py:107"),
    "K2": ("range_probe", "hyperspace_tpu_torch/csrc/range_probe.cu", "hyperspace_tpu/ops/pallas_probe.py:129"),
    "K3": ("comp_sort", "hyperspace_tpu_torch/csrc/comp_sort.cu", "hyperspace_tpu/ops/pallas_sort.py:256"),
    "K4": ("packed_sort", "hyperspace_tpu_torch/csrc/packed_sort.cu", "hyperspace_tpu/ops/pallas_sort.py:210"),
    "K5": ("packed_probe", "hyperspace_tpu_torch/csrc/packed_probe.cu", "hyperspace_tpu/ops/pallas_probe.py:254"),
    "K6": ("key_hash", "hyperspace_tpu_torch/csrc/key_hash.cu", "none (hyperspace_tpu/ops/hashing.py:324 is fused jnp)"),
}


#: The reference's examples and the line each prints when it succeeds.
EXAMPLES = (("quickstart.py", "results identical with indexing on/off — OK"), ("walkthrough.py", "WALKTHROUGH_OK"))
_PLATFORM_LINE = re.compile(r'^\s*(import\s+jax\s*$|jax\.config\.update\(|os\.environ\.setdefault\("XLA_FLAGS")')
_PACKAGE_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)hyperspace_tpu\b")


def port_example_source(source: str) -> str:
    """A program written for the JAX package, made to run on the port: its
    imports name `hyperspace_tpu_torch` and its JAX platform lines are
    dropped; nothing else changes."""
    return "".join(_PACKAGE_IMPORT.sub(r"\1hyperspace_tpu_torch", line)
                   for line in source.splitlines(keepends=True) if not _PLATFORM_LINE.match(line))


def phase_surface(torch, data, base: str):
    """Phase surface (module docstring, 21)."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.ops import cuda_hash, cuda_probe, cuda_sort
    from hyperspace_tpu_torch.telemetry import device_observatory, profiling

    reset_launches(cuda_sort, cuda_probe, cuda_hash)
    wh = os.path.join(base, "surface")
    s = hst.HyperspaceSession(warehouse=wh)
    card_check(s.device.type == "cuda" and hst.HyperspaceSession.active() is s,
               f"surface: the default session is on {s.device} or not the active one")
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    hs = hst.Hyperspace()
    card_check(hs._session is s, "surface: Hyperspace() did not take the active session")
    build_s = {}
    for src, name, indexed, included in (i for i in INDEXES if i[1] in ("liOrd", "ordIdx")):
        cfg = hst.IndexConfig.builder().index_name(name).index_by(*indexed).include(*included).create()
        if cfg != hst.IndexConfig(name, indexed, included):
            raise AssertionError(f"surface: the builder made {cfg}")
        df = s.read.parquet(os.path.join(base, "src", src))
        _, build_s[name] = wall(lambda: hs.create_index(df, cfg))
    hst.enable_hyperspace(s)
    q = queries(s, base)["q_ord"]
    if scanned_indexes(q) != ["liOrd", "ordIdx"]:
        raise AssertionError(f"surface: q_ord does not scan the indexes:\n{q.explain_string()}")
    li, od = data["lineitem"], data["orders"]
    a, b = np_join(li["l_orderkey"], od["o_orderkey"])
    want = canonical({"l_extendedprice": li["l_extendedprice"][a], "o_custkey": od["o_custkey"][b]})
    trace_dir = os.path.join(base, "surface_trace")
    clear_caches()
    k2 = cuda_probe.launches
    with profiling.trace(trace_dir):
        with profiling.annotate("q_ord"):
            out, t_traced = wall(q.collect)
    check_answer("q_ord", out.num_rows, out, {"q_ord": want}, None)
    traced_k2 = cuda_probe.launches - k2
    with open(os.path.join(trace_dir, device_observatory.CHROME_TRACE_NAME)) as fh:
        events = json.load(fh)["traceEvents"]
    regions = sum(1 for e in events if e.get("name") == "q_ord")
    kernel_names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    k2_seen = sorted(n for n in kernel_names if any(g in n for g in K2_GLOBALS))
    card_check(regions > 0 and bool(k2_seen) and traced_k2 > 0,
               f"surface: the trace names the region {regions} times and K2's kernel as {k2_seen} "
               f"({traced_k2} K2 launches) among {sorted(kernel_names)[:20]}")
    log(f"[surface] builds through IndexConfig.builder() {json.dumps(build_s)}; traced q_ord {out.num_rows} rows "
        f"equal numpy in {t_traced} s; trace: {len(events)} events, region 'q_ord' {regions}, K2 kernel "
        f"{k2_seen}, {traced_k2} K2 launches; {len(kernel_names)} distinct kernel names")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = root
    for name, success in EXAMPLES:
        with open(os.path.join(root, "examples", name)) as fh:
            ported = port_example_source(fh.read())
        path = os.path.join(base, "surface_examples", name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(ported)
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, path], capture_output=True, text=True, env=env, timeout=600,
                               cwd=os.path.dirname(path))
        t_child = time.perf_counter() - t0
        if child.returncode != 0 or success not in child.stdout.splitlines():
            raise AssertionError(f"surface: {name} on the port exited {child.returncode}:\n"
                                 f"{child.stdout[-3000:]}\n{child.stderr[-3000:]}")
        log(f"[surface] examples/{name} on the card: {len(child.stdout.splitlines())} lines ending in "
            f"{success!r}, {t_child} s in its own process")
    launches = {"K1": cuda_sort.launches, "K2": cuda_probe.launches, "K6": cuda_hash.launches}
    log(f"[surface] launches {json.dumps(launches)}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="env,kernels,main,dense,mesh,q3,strings,packed,refresh,q13,skipping,delta,partitioned,"
                            "setops,star,resilience,analyze,history,serve,surface,identity")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--identity-sf", type=float, default=0.05)
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from hyperspace_tpu_torch.ops import _kernels
    except ImportError as e:
        print(f"chip_smoke: hyperspace_tpu_torch is not importable here: {e}", file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    log(smi)
    log(f"[env] torch {torch.__version__} CUDA {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    _kernels.library()
    log(f"[env] kernels built in {_kernels.build_seconds:.2f} s")
    rng = np.random.RandomState(args.seed)
    phase_seconds = {}

    def timed_phase(name, fn, *args):
        """Run one phase, keeping its wall seconds for the `[phases]` line."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_seconds[name] = round(time.perf_counter() - t0, 2)
        return out

    shapes = timed_phase("kernels", phase_kernels, torch, rng) if "kernels" in phases else []
    launches = {}

    def add(counts: dict) -> None:
        """A phase's launches, counted from 0 at its start, into the totals."""
        for kid, n in counts.items():
            launches[kid] = launches.get(kid, 0) + n

    data, dense_rows = None, []
    if {"main", "dense", "mesh", "q3", "strings", "packed", "refresh", "q13", "delta", "resilience", "analyze",
            "history", "serve", "surface"} & set(phases):
        t0 = time.perf_counter()
        data = tpch(args.sf, args.seed)
        log(f"[data] TPC-H SF{args.sf}: lineitem {len(data['lineitem']['l_orderkey'])} rows, orders "
            f"{len(data['orders']['o_orderkey'])}, partsupp {len(data['partsupp']['ps_partkey'])}, customer "
            f"{len(data['customer']['c_custkey'])} (generated in {time.perf_counter() - t0:.2f} s)")
    base = tempfile.mkdtemp(prefix="hs_smoke_sf1_")
    try:
        if {"main", "dense", "mesh", "q3", "strings", "q13", "resilience", "analyze", "history", "serve",
                "surface"} & set(phases):
            write_sources(data, base)
        main_times = None
        if "main" in phases:
            counts, _, main_times = timed_phase("main", phase_main, torch, data, base)
            add(counts)
        if "dense" in phases:
            if "main" not in phases:
                build(base, DEVICE)  # phase dense runs on main's indexes
            counts, _, _, dense_rows = timed_phase("dense", phase_dense, torch, data, base, args.seed, main_times)
            add(counts)
        if "mesh" in phases:
            add(timed_phase("mesh", phase_mesh, torch, data, base)[0])
        if "q3" in phases:
            add(timed_phase("q3", phase_q3, torch, data, base)[0])
        if "strings" in phases:
            add(timed_phase("strings", phase_strings, torch, data, base, args.seed)[0])
        if "packed" in phases:
            add(timed_phase("packed", phase_packed, torch, data, rng)[0])
        if "refresh" in phases:
            add(timed_phase("refresh", phase_refresh, torch, data, base)[0])
        if "q13" in phases:
            add(timed_phase("q13", phase_q13, torch, data, base, args.seed)[0])
        if "skipping" in phases:
            add(timed_phase("skipping", phase_skipping, torch, base, args.seed)[0])
        if "delta" in phases:
            add(timed_phase("delta", phase_delta, torch, data, base)[0])
        if "partitioned" in phases:
            add(timed_phase("partitioned", phase_partitioned, torch, base, args.seed)[0])
        if "setops" in phases:
            add(timed_phase("setops", phase_setops, torch, base, args.seed)[0])
        if "star" in phases:
            add(timed_phase("star", phase_star, torch, base, args.seed)[0])
        if "resilience" in phases:
            add(timed_phase("resilience", phase_resilience, torch, data, base, args.seed)[0])
        if "analyze" in phases:
            add(timed_phase("analyze", phase_analyze, torch, data, base, args.seed)[0])
        if "history" in phases:
            add(timed_phase("history", phase_history, torch, data, base, args.seed)[0])
        if "serve" in phases:
            add(timed_phase("serve", phase_serve, torch, data, base, args.seed)[0])
        if "surface" in phases:
            add(timed_phase("surface", phase_surface, torch, data, base))
            log(f"[surface] phase seconds {phase_seconds['surface']} on {smi}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    if "identity" in phases:
        timed_phase("identity", phase_identity, torch, args.seed, args.identity_sf)
    log(f"[phases] seconds {json.dumps(phase_seconds)}")
    kernels = []
    for kid, (name, source, replaces) in KERNEL_META.items():
        main_shape = next((s for s in shapes if s["kernel"] == kid), None)
        if main_shape is None:
            continue
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(kid, 0), "max_abs_err": main_shape["max_abs_err"],
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
        })
    for row in dense_rows:  # K1 and K2 at phase dense's hash-mode shapes, with the phase's launches there
        name, source, replaces = KERNEL_META[row["kernel"]]
        dims = "_".join("x".join(map(str, d)) for d in (row["shape"] if row["kernel"] == "K2" else [row["shape"]]))
        kernels.append({
            "name": f"{name}_dense_{row['pair']}_{dims}", "route": "cuda", "source": source, "replaces": replaces,
            "launches": row["launches"], **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                                "bound_by", "library_ms", "shape")},
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
