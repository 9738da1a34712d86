"""TPC-H lineitem generator for the port's slice (tests and chip_smoke.py).

The port's own copy of the JAX package's `benchmarks/datagen.py::
gen_tpch_lineitem`: the full 16-column TPC-H lineitem schema, 1 to 7
lines per order (TPC-H's SF1 table holds 6,001,215 rows; this generator
gives 6,001,991 at SF1 with seed 42), written chunk by chunk with a
seed derived per file, so the same `sf` and `seed` give the same files
as the JAX package's generator.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

TPCH_SF1_ORDERS_ROWS = 1_500_000

_RETURNFLAGS = np.array(["A", "N", "R"], dtype=object)
_LINESTATUS = np.array(["F", "O"], dtype=object)
_SHIPINSTRUCT = np.array(
    ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"], dtype=object
)
_SHIPMODE = np.array(
    ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"], dtype=object
)
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
