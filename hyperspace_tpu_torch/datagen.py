"""TPC-H lineitem, orders and customer generators, the TPC-DS store
channel, and the clustered embedding table, for the port (tests and
chip_smoke.py).

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
seed gives the same matrix and the same file (its `appended` draw, which
the JAX package's lacks, writes a second file and leaves the first as it
was). `gen_trips_batch` is a copy of `benchmarks/datagen.py`'s NYC-Taxi
batch (`trip_id`, `zone` in 0-264, `fare`, `distance`; a file a batch).
The TPC-DS store channel is
a copy of `benchmarks/tpcds.py`'s `gen_date_dim` (73,049 days from
1900-01-02), `gen_item` (18,000 rows at SF1), `gen_store` (12 rows) and
`gen_store_sales` (2,879,987 rows and 17 columns at SF1, in tickets of
about nine items), with the helpers and constants they read: the same
`sf` and seed give the same files.
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


def gen_embeddings(
    root: Path, n: int, dim: int, clusters: int, seed: int = 7, appended: int = 0
) -> np.ndarray:
    """Clustered embedding table (`id` int64, `emb` float32 FixedSizeList of
    `dim`) in one parquet file under `root`; returns the raw [n, dim]
    matrix for querying. With `appended` > 0, the `appended` rows drawn
    after those n from the same clusters are written instead, to
    `part-1.parquet` with ids n, n+1, ..., and returned [appended, dim]:
    an append to the table the same call without it writes."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32) * 4
    emb = centers[rng.integers(0, clusters, n)] + rng.standard_normal((n, dim)).astype(np.float32)
    first, name = 0, "part-0.parquet"
    if appended:
        emb = centers[rng.integers(0, clusters, appended)] + rng.standard_normal((appended, dim)).astype(np.float32)
        first, name = n, "part-1.parquet"
    t = pa.table(
        {
            "id": pa.array(np.arange(first, first + len(emb), dtype=np.int64)),
            "emb": pa.FixedSizeListArray.from_arrays(pa.array(emb.reshape(-1), type=pa.float32()), dim),
        }
    )
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    pq.write_table(t, root / name)
    return emb


def gen_trips_batch(root: Path, n: int, batch: int, seed: int = 50) -> int:
    """One append batch of taxi-trip-shaped rows (file per batch); returns
    the batch's in-memory byte size."""
    rng = np.random.default_rng(seed + batch)
    t = pa.table(
        {
            "trip_id": (np.arange(n, dtype=np.int64) + batch * n),
            "zone": rng.integers(0, 265, n).astype(np.int64),
            "fare": (rng.random(n) * 80),
            "distance": (rng.random(n) * 30),
        }
    )
    root.mkdir(parents=True, exist_ok=True)
    pq.write_table(t, root / f"batch-{batch:04d}.parquet")
    return t.nbytes


# -- TPC-DS store channel (a copy of the JAX package's benchmarks/tpcds.py) ----

SS_SF1_ROWS = 2_879_987
ITEM_SF1_ROWS = 18_000
CUSTOMER_SF1_ROWS = 100_000
CA_SF1_ROWS = 50_000
CD_ROWS = 1_920_800  # fixed cartesian size in TPC-DS
HD_ROWS = 7_200
DD_ROWS = 73_049  # 1900-01-02 .. 2100-01-01
DD_SK0 = 2_415_022  # julian day number of the first date_dim row
STORE_ROWS = 12
# Sold-date window every sales channel draws from (julian d_date_sk for
# 1998-01-01 .. 2002-12-31 — the years the published queries probe).
SOLD_DATE_LO = DD_SK0 + int((np.datetime64("1998-01-01") - np.datetime64("1900-01-02")) // np.timedelta64(1, "D"))
SOLD_DATE_HI = DD_SK0 + int((np.datetime64("2002-12-31") - np.datetime64("1900-01-02")) // np.timedelta64(1, "D"))

_CATEGORIES = np.array(
    ["Books", "Children", "Electronics", "Home", "Jewelry",
     "Men", "Music", "Shoes", "Sports", "Women"], dtype=object
)
_STATES = np.array(
    ["TX", "OH", "OR", "CA", "WA", "NM", "KY", "VA", "FL", "GA", "MI", "IL"], dtype=object
)
_STORE_NAMES = np.array(
    ["ought", "able", "pri", "ese", "anti", "cally", "ation", "eing",
     "ought", "able", "ese", "bar"], dtype=object
)
_CITIES = np.array(
    ["Midway", "Fairview", "Oak Grove", "Five Points", "Pleasant Hill",
     "Centerville", "Liberty", "Salem", "Union", "Riverside"], dtype=object
)


def _write_parts(t: pa.Table, root: Path, files: int) -> None:
    """Chunked parquet write (the JAX package's benchmarks/datagen.py
    helper), so the same table gives the same files."""
    root.mkdir(parents=True, exist_ok=True)
    per = (t.num_rows + files - 1) // files
    for i in range(files):
        part = t.slice(i * per, per)
        if part.num_rows:
            pq.write_table(part, root / f"part-{i}.parquet", row_group_size=262_144)


def _parts(t: pa.Table, root: Path, files: int) -> int:
    _write_parts(t, root, files)
    return t.nbytes


def gen_date_dim(root: Path) -> int:
    """Deterministic calendar: one row per day 1900-01-02..2100-01-01,
    julian d_date_sk numbering as dsdgen emits. d_month_seq/d_week_seq
    are the running month/week ordinals the published queries window on
    (q6's month pick, q59's week join, q98's 30-day month_seq spans)."""
    days = np.arange(DD_ROWS, dtype=np.int64)
    d64 = np.datetime64("1900-01-02") + days
    years = d64.astype("datetime64[Y]").astype(np.int64) + 1970
    months0 = d64.astype("datetime64[M]").astype(np.int64)
    moy = months0 % 12 + 1
    dom = (d64 - d64.astype("datetime64[M]")).astype(np.int64) + 1
    dow = (d64.astype("datetime64[D]").astype(np.int64) + 4) % 7  # 0=Sunday
    names = np.array(
        ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday"],
        dtype=object,
    )
    month_seq = months0 - int(
        np.datetime64("1900-01", "M").astype(np.int64)
    )  # 0 at Jan 1900, as dsdgen counts
    week_seq = (days + 1) // 7  # week ordinal from the calendar origin
    t = pa.table(
        {
            "d_date_sk": DD_SK0 + days,
            "d_date": pa.array(
                (d64 - np.datetime64("1970-01-01")).astype(np.int32), type=pa.date32()
            ),
            "d_year": years.astype(np.int32),
            "d_moy": moy.astype(np.int32),
            "d_dom": dom.astype(np.int32),
            "d_qoy": ((moy - 1) // 3 + 1).astype(np.int32),
            "d_day_name": pa.array(names[dow]),
            "d_month_seq": month_seq.astype(np.int32),
            "d_week_seq": week_seq.astype(np.int32),
            "d_dow": dow.astype(np.int32),
        }
    )
    return _parts(t, root, 1)


def item_rows(sf: float) -> int:
    """item scales sublinearly in TPC-DS; pinned to the SF1 size above
    SF1 (good enough for this slice) and proportionally below."""
    return max(int(ITEM_SF1_ROWS * min(sf, 1.0)), 100)


def gen_item(root: Path, sf: float = 1.0, seed: int = 61) -> int:
    n = item_rows(sf)
    rng = np.random.default_rng(seed)
    manufact = rng.integers(1, 1001, n).astype(np.int32)
    brand_id = (manufact * 1000 + rng.integers(1, 1000, n)).astype(np.int32)
    cat_id = rng.integers(1, 11, n).astype(np.int32)
    t = pa.table(
        {
            "i_item_sk": np.arange(1, n + 1, dtype=np.int64),
            "i_item_id": pa.array(
                np.char.add("AAAAAAAA", np.arange(n).astype("U8")).astype(object)
            ),
            "i_brand_id": brand_id,
            "i_brand": pa.array(
                np.char.add("brandbrand#", brand_id.astype("U8")).astype(object)
            ),
            "i_manufact_id": manufact,
            "i_manager_id": rng.integers(1, 101, n).astype(np.int32),
            "i_category_id": cat_id,
            "i_category": pa.array(_CATEGORIES[cat_id - 1]),
            "i_class": pa.array(
                np.char.add("class", rng.integers(1, 17, n).astype("U2")).astype(object)
            ),
            "i_current_price": np.round(rng.random(n) * 99 + 1, 2),
            "i_item_desc": pa.array(
                np.char.add("desc", (np.arange(n) % 997).astype("U4")).astype(object)
            ),
            "i_color": pa.array(
                np.array(["maroon", "burnished", "dim", "sky", "navajo", "chiffon",
                          "slate", "blanched", "tan", "forest", "lace", "misty",
                          "cream", "dark", "powder", "frosted", "almond", "smoke"],
                         dtype=object)[rng.integers(0, 18, n)]
            ),
            "i_units": pa.array(
                np.array(["Each", "Dozen", "Case", "Pallet", "Gross", "Ton",
                          "Ounce", "Bunch"], dtype=object)[rng.integers(0, 8, n)]
            ),
        }
    )
    return _parts(t, root, 1)


def gen_store(root: Path) -> int:
    n = STORE_ROWS
    t = pa.table(
        {
            "s_store_sk": np.arange(1, n + 1, dtype=np.int64),
            "s_store_id": pa.array(
                np.char.add("AAAAAAAA", np.arange(n).astype("U2")).astype(object)
            ),
            "s_store_name": pa.array(_STORE_NAMES[:n]),
            "s_state": pa.array(_STATES[:n]),
            "s_zip": pa.array(
                np.char.add("55", (np.arange(n) * 137 % 1000).astype("U3")).astype(object)
            ),
            "s_gmt_offset": np.full(n, -5.0),
            "s_county": pa.array(
                np.array(["Ziebach County", "Williamson County", "Walker County",
                          "Daviess County"], dtype=object)[np.arange(n) % 4]
            ),
            "s_city": pa.array(_CITIES[np.arange(n) % len(_CITIES)]),
            "s_company_name": pa.array(np.full(n, "Unknown", dtype=object)),
            "s_number_of_employees": (200 + np.arange(n) * 13 % 100).astype(np.int32),
        }
    )
    return _parts(t, root, 1)


def cd_rows(sf: float) -> int:
    """customer_demographics is fixed-size in TPC-DS; scaled down below
    SF1 (keeping full field-cycle coverage) so tiny test runs stay fast."""
    return CD_ROWS if sf >= 1 else max(int(CD_ROWS * sf), 11_200)


def ca_rows(sf: float) -> int:
    return max(int(CA_SF1_ROWS * max(sf, 0.02)), 100)


def customer_rows(sf: float) -> int:
    return int(CUSTOMER_SF1_ROWS * max(sf, 0.02))



def _null_frac(arr: np.ndarray, frac: float, rng) -> pa.Array:
    """Arrow column with a `frac` fraction of NULLs (dsdgen emits null
    FKs; q76 counts the rows whose channel FK IS NULL)."""
    return pa.array(arr, mask=rng.random(len(arr)) < frac)



def _ss_table(sf: float, seed: int = 60) -> pa.Table:
    """The store fact table. Sold dates concentrate in 1998-2002 (the
    years the published queries probe), store hours 08:00-21:00. Rows
    group into multi-item TICKETS (dsdgen's structure): all rows of one
    ss_ticket_number share customer / date / time / store / demographics
    / address — the grain q34/q46/q68/q73/q79 aggregate on. ss_addr_sk
    carries ~1% NULLs (q76's store-channel probe)."""
    n = int(SS_SF1_ROWS * sf)
    rng = np.random.default_rng(seed)
    lo, hi = SOLD_DATE_LO, SOLD_DATE_HI
    n_items = item_rows(sf)
    n_ca = ca_rows(sf)
    # Ticket runs: ~9 items per ticket in expectation.
    start = rng.random(n) < (1.0 / 9.0)
    if n:
        start[0] = True
    tid = np.cumsum(start, dtype=np.int64) - 1  # 0-based ticket ordinal
    n_t = int(tid[-1]) + 1 if n else 0

    def per_ticket(vals: np.ndarray) -> np.ndarray:
        return vals[tid]

    quantity = rng.integers(1, 101, n).astype(np.int32)
    list_price = np.round(rng.random(n) * 190 + 10, 2)
    sales_price = np.round(list_price * (0.2 + rng.random(n) * 0.8), 2)
    wholesale = np.round(list_price * (0.3 + rng.random(n) * 0.4), 2)
    t = pa.table(
        {
            "ss_sold_date_sk": per_ticket(rng.integers(lo, hi + 1, n_t)).astype(np.int64),
            "ss_sold_time_sk": per_ticket(rng.integers(8 * 3600, 21 * 3600, n_t)).astype(np.int64),
            "ss_item_sk": rng.integers(1, n_items + 1, n).astype(np.int64),
            "ss_customer_sk": per_ticket(
                rng.integers(1, customer_rows(sf) + 1, n_t)
            ).astype(np.int64),
            "ss_cdemo_sk": per_ticket(rng.integers(1, cd_rows(sf) + 1, n_t)).astype(np.int64),
            "ss_hdemo_sk": per_ticket(rng.integers(1, HD_ROWS + 1, n_t)).astype(np.int64),
            "ss_addr_sk": _null_frac(
                per_ticket(rng.integers(1, n_ca + 1, n_t)).astype(np.int64), 0.01, rng
            ),
            "ss_store_sk": per_ticket(rng.integers(1, STORE_ROWS + 1, n_t)).astype(np.int64),
            "ss_promo_sk": rng.integers(1, 301, n).astype(np.int64),
            "ss_ticket_number": (tid + 1).astype(np.int64),
            "ss_quantity": quantity,
            "ss_list_price": list_price,
            "ss_sales_price": sales_price,
            "ss_ext_wholesale_cost": np.round(quantity * wholesale, 2),
            "ss_coupon_amt": np.round(np.where(rng.random(n) < 0.2, rng.random(n) * 50, 0.0), 2),
            "ss_ext_sales_price": np.round(quantity * sales_price, 2),
            "ss_net_profit": np.round(quantity * (sales_price - list_price * 0.5), 2),
        }
    )
    return t


def gen_store_sales(root: Path, sf: float = 1.0, seed: int = 60, files: int = 8) -> int:
    return _parts(_ss_table(sf, seed), root, files)
