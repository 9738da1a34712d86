"""TPC-H lineitem, orders and customer generators, and the clustered
embedding table, for the port (tests and chip_smoke.py).

The port's own copies of the JAX package's `benchmarks/datagen.py::
gen_tpch_lineitem`, `gen_tpch_orders` and `gen_tpch_customer` (150,000
rows at SF1, seed 45, `c_custkey` in `o_custkey`'s domain): the full 16-column TPC-H
lineitem schema, 1 to 7 lines per order (TPC-H's SF1 table holds
6,001,215 rows; this generator gives 6,001,991 at SF1 with seed 42), and
the 9-column orders table (1.5M rows at SF1, `o_orderkey` in
`[0, n_orders)`, the domain `l_orderkey` draws from). Both are written
chunk by chunk with a seed derived per file, so the same `sf` and `seed`
give the same files as the JAX package's generators. `gen_embeddings` is
the port's copy of the JAX package's generator of the same name: the same
seed gives the same matrix and the same file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

TPCH_SF1_ORDERS_ROWS = 1_500_000
TPCH_SF1_CUSTOMER_ROWS = 150_000

_RETURNFLAGS = np.array(["A", "N", "R"], dtype=object)
_LINESTATUS = np.array(["F", "O"], dtype=object)
_SHIPINSTRUCT = np.array(
    ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"], dtype=object
)
_SHIPMODE = np.array(
    ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"], dtype=object
)
_ORDERPRIORITY = np.array(
    ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"], dtype=object
)
_ORDERSTATUS = np.array(["F", "O", "P"], dtype=object)
_SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"], dtype=object)
_EPOCH_1992 = 8035  # days from 1970-01-01 to 1992-01-01
_DATE_SPAN = 2525  # order dates span 1992-01-01 .. 1998-12-01 (TPC-H 4.2.3)


def gen_tpch_lineitem(
    root: Path, sf: float = 1.0, seed: int = 42, files: int | None = None
) -> int:
    """TPC-H-faithful lineitem: full 16-column schema (ints, decimals as
    float64, 1-char flags, dates, mode/instruction strings, comments),
    ~4 lines per order (SF1 ≈ 6.0M rows). Generated CHUNK BY CHUNK —
    each file covers a contiguous order range with its own derived seed
    — so peak memory stays one chunk regardless of scale factor (SF10+
    would not fit a full-table build). Deterministic under the seed;
    returns total in-memory byte size."""
    n_orders = int(TPCH_SF1_ORDERS_ROWS * sf)
    if files is None:
        files = max(8, int(round(8 * sf)))
    root.mkdir(parents=True, exist_ok=True)
    per_orders = (n_orders + files - 1) // files
    total = 0
    for i in range(files):
        o0, o1 = i * per_orders, min((i + 1) * per_orders, n_orders)
        if o0 >= o1:
            break
        rng = np.random.default_rng(seed + 7919 * i)
        # ~4 lines per order: repeat each orderkey a random 1-7 times.
        orderkey = np.repeat(
            np.arange(o0, o1, dtype=np.int64), rng.integers(1, 8, o1 - o0)
        )
        m = len(orderkey)
        shipdate = (
            _EPOCH_1992 + rng.integers(0, _DATE_SPAN, m) + rng.integers(1, 122, m)
        ).astype(np.int32)
        quantity = rng.integers(1, 51, m).astype(np.float64)
        extendedprice = np.round(quantity * (900 + rng.random(m) * 100_000) / 100, 2)
        comments = np.char.add(
            np.char.add(
                _SHIPMODE[rng.integers(0, len(_SHIPMODE), m)].astype(str), " carefully "
            ),
            _SHIPINSTRUCT[rng.integers(0, 4, m)].astype(str),
        )
        t = pa.table(
            {
                "l_orderkey": orderkey,
                "l_partkey": rng.integers(0, int(200_000 * max(sf, 0.01)), m).astype(np.int64),
                "l_suppkey": rng.integers(0, int(10_000 * max(sf, 0.01)), m).astype(np.int64),
                "l_linenumber": np.ones(m, dtype=np.int32),
                "l_quantity": quantity,
                "l_extendedprice": extendedprice,
                "l_discount": np.round(rng.integers(0, 11, m) / 100.0, 2),
                "l_tax": np.round(rng.integers(0, 9, m) / 100.0, 2),
                "l_returnflag": pa.array(_RETURNFLAGS[rng.integers(0, 3, m)]),
                "l_linestatus": pa.array(_LINESTATUS[(shipdate > _EPOCH_1992 + 1260).astype(int)]),
                "l_shipdate": pa.array(shipdate, type=pa.date32()),
                "l_commitdate": pa.array(shipdate + rng.integers(-30, 31, m).astype(np.int32), type=pa.date32()),
                "l_receiptdate": pa.array(shipdate + rng.integers(1, 31, m).astype(np.int32), type=pa.date32()),
                "l_shipinstruct": pa.array(_SHIPINSTRUCT[rng.integers(0, 4, m)]),
                "l_shipmode": pa.array(_SHIPMODE[rng.integers(0, 7, m)]),
                "l_comment": pa.array(comments.astype(object)),
            }
        )
        pq.write_table(t, root / f"part-{i}.parquet", row_group_size=262_144)
        total += t.nbytes
    return total


def gen_tpch_orders(root: Path, sf: float = 1.0, seed: int = 43, files: int | None = None) -> int:
    """TPC-H-faithful orders (9 columns, SF1 = 1.5M rows), generated
    chunk by chunk like lineitem. Deterministic under the seed; returns
    total in-memory byte size."""
    n = int(TPCH_SF1_ORDERS_ROWS * sf)
    if files is None:
        files = max(4, int(round(4 * sf)))
    root.mkdir(parents=True, exist_ok=True)
    per = (n + files - 1) // files
    total = 0
    for i in range(files):
        k0, k1 = i * per, min((i + 1) * per, n)
        if k0 >= k1:
            break
        rng = np.random.default_rng(seed + 7919 * i)
        m = k1 - k0
        orderdate = (_EPOCH_1992 + rng.integers(0, _DATE_SPAN, m)).astype(np.int32)
        t = pa.table(
            {
                "o_orderkey": np.arange(k0, k1, dtype=np.int64),
                "o_custkey": rng.integers(0, n // 10 + 1, m).astype(np.int64),
                "o_orderstatus": pa.array(_ORDERSTATUS[rng.integers(0, 3, m)]),
                "o_totalprice": np.round(rng.random(m) * 500_000, 2),
                "o_orderdate": pa.array(orderdate, type=pa.date32()),
                "o_orderpriority": pa.array(_ORDERPRIORITY[rng.integers(0, 5, m)]),
                "o_clerk": pa.array(
                    np.char.add("Clerk#", rng.integers(1, 1001, m).astype("U6")).astype(object)
                ),
                "o_shippriority": np.zeros(m, dtype=np.int32),
                # ~1.2% of comments match Q13's '%special%requests%' exclusion.
                "o_comment": pa.array(
                    np.where(
                        rng.random(m) < 0.012,
                        "the special packages wake furiously among the requests",
                        np.char.add(
                            _ORDERPRIORITY[rng.integers(0, 5, m)].astype(str),
                            " instructions sleep quickly",
                        ).astype(object),
                    ).astype(object)
                ),
            }
        )
        pq.write_table(t, root / f"part-{i}.parquet", row_group_size=262_144)
        total += t.nbytes
    return total


def gen_tpch_customer(root: Path, sf: float = 1.0, seed: int = 45, files: int = 2) -> int:
    """TPC-H customer (SF1 = 150k rows), `c_custkey` in orders'
    `o_custkey` domain (Q13's shape). Deterministic under the seed;
    returns the in-memory byte size."""
    n = int(TPCH_SF1_CUSTOMER_ROWS * sf)
    rng = np.random.default_rng(seed)
    t = pa.table(
        {
            "c_custkey": np.arange(n, dtype=np.int64),
            "c_name": pa.array(np.char.add("Customer#", np.arange(n).astype("U9")).astype(object)),
            "c_phone": pa.array(
                np.char.add(
                    np.char.add(rng.integers(10, 35, n).astype("U2"), "-555-"),
                    rng.integers(1000, 10000, n).astype("U4"),
                ).astype(object)
            ),
            "c_acctbal": np.round(rng.random(n) * 10_000 - 1_000, 2),
            "c_mktsegment": pa.array(_SEGMENTS[rng.integers(0, 5, n)]),
            "c_nationkey": rng.integers(0, 25, n).astype(np.int32),
        }
    )
    root.mkdir(parents=True, exist_ok=True)
    per = (t.num_rows + files - 1) // files
    for i in range(files):
        part = t.slice(i * per, per)
        if part.num_rows:
            pq.write_table(part, root / f"part-{i}.parquet", row_group_size=262_144)
    return t.nbytes


def gen_embeddings(root: Path, n: int, dim: int, clusters: int, seed: int = 7) -> np.ndarray:
    """Clustered embedding table (`id` int64, `emb` float32 FixedSizeList of
    `dim`) in one parquet file under `root`; returns the raw [n, dim]
    matrix for querying."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32) * 4
    emb = centers[rng.integers(0, clusters, n)] + rng.standard_normal((n, dim)).astype(np.float32)
    t = pa.table(
        {
            "id": pa.array(np.arange(n, dtype=np.int64)),
            "emb": pa.FixedSizeListArray.from_arrays(pa.array(emb.reshape(-1), type=pa.float32()), dim),
        }
    )
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    pq.write_table(t, root / "part-0.parquet")
    return emb
