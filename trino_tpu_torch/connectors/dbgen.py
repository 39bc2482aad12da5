"""Spec-exact TPC-H data generation (dbgen algorithm), vectorized.

The TPC-H specification defines data generation normatively: per-column
multiplicative Lehmer streams (seed' = seed * 16807 mod 2^31-1) with fixed
starting seeds and fixed seed-consumption per row, so any row range can be
generated independently by skipping streams ahead (reference:
``plugin/trino-tpch/pom.xml:21-22`` — the reference delegates to the
``io.trino.tpch`` generator implementing the same algorithm;
``TpchRecordSet.java`` drives it per split).

Every stream constant in this module is verified against dbgen-produced
fixtures (see tests/test_dbgen.py): per-row SF1 lineitem/orders files and
the SF1 answer set that ship as reference test resources. Several seeds
were *solved* from those fixtures by interval constraint propagation over
the Lehmer recurrence, so they are exact by construction.

Skip-ahead math: seed after k draws = seed0 * 16807^k mod M. For a chunk
we build a table of successive powers (int64-safe: both factors < 2^31)
and index it by each draw's per-row offset — fully vectorized, no Python
loop over rows.
"""

from __future__ import annotations

import numpy as np

M = 2147483647  # 2^31 - 1 (prime)
A = 16807  # Lehmer multiplier (7^5)

# --- scale bases (spec 4.2.5) ------------------------------------------

CUSTOMER_BASE = 150_000
ORDER_BASE = 1_500_000
PART_BASE = 200_000
SUPPLIER_BASE = 10_000
SUPPLIERS_PER_PART = 4
ORDERS_PER_CUSTOMER = 10
CUSTOMER_MORTALITY = 3  # 1/3 of customers place no orders
CLERK_BASE = 1_000

# date arithmetic: day offsets from 1992-01-01 (spec: dates span 2557 days
# 1992-01-01..1998-12-31; order dates stop 151 days early)
TOTAL_DATE_RANGE = 2_557
ORDER_DATE_RANGE = TOTAL_DATE_RANGE - 151  # 2406 values, verified
CURRENT_DATE_OFFSET = 1_263  # 1995-06-17

LINES_PER_ORDER_MAX = 7


def counts(sf: float) -> dict:
    return {
        "region": 5,
        "nation": 25,
        "supplier": max(1, round(SUPPLIER_BASE * sf)),
        "customer": max(1, round(CUSTOMER_BASE * sf)),
        "part": max(1, round(PART_BASE * sf)),
        "partsupp": max(1, round(PART_BASE * sf)) * SUPPLIERS_PER_PART,
        "orders": max(1, round(ORDER_BASE * sf)),
    }


# --- Lehmer stream core -------------------------------------------------


def advance(seed: int, k: int) -> int:
    """Seed after k draws (skip-ahead via modular exponentiation)."""
    return (seed * pow(A, k % (M - 1), M)) % M


_POW_CACHE: dict[int, np.ndarray] = {}


def pow_table(n: int) -> np.ndarray:
    """P[k] = 16807^k mod M for k in [0, n], built by doubling (each step
    one vectorized int64 multiply; products < 2^62 never overflow)."""
    for size in sorted(_POW_CACHE):
        if size >= n:
            return _POW_CACHE[size]
    size = max(n, 1 << 14)
    P = np.empty(size + 1, dtype=np.int64)
    P[0] = 1
    P[1] = A
    filled = 1
    while filled < size:
        step = min(filled, size - filled)
        P[filled + 1 : filled + step + 1] = (
            P[1 : step + 1] * P[filled]
        ) % M
        filled += step
    _POW_CACHE.clear()
    _POW_CACHE[size] = P
    return P


def stream_seeds(seed0: int, exps: np.ndarray) -> np.ndarray:
    """Seed values at 1-based draw positions ``exps`` (int64 array)."""
    base = seed0 % M
    P = pow_table(int(exps.max()) if exps.size else 1)
    return (base * P[exps]) % M


def bounded(seeds: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """dbgen UnifInt: lo + trunc(seed/M * range) — float64 math exactly as
    the reference implementation computes it."""
    rng = hi - lo + 1
    return lo + ((seeds.astype(np.float64) / M) * rng).astype(np.int64)


class Stream:
    """One per-column Lehmer stream with fixed seeds-per-row."""

    def __init__(self, seed0: int, spr: int):
        self.seed0 = seed0
        self.spr = spr

    def row_draws(self, row0: int, n_rows: int, uses: int = 1) -> np.ndarray:
        """Seeds for draws (row, j): shape (n_rows, uses). Row indexes are
        0-based; draw j of row r sits at global position r*spr + j + 1."""
        start = advance(self.seed0, row0 * self.spr)
        i = np.arange(n_rows, dtype=np.int64)[:, None]
        j = np.arange(uses, dtype=np.int64)[None, :]
        exps = i * self.spr + j + 1
        return stream_seeds(start, exps)

    def rows(self, row0: int, n_rows: int, lo: int, hi: int) -> np.ndarray:
        return bounded(self.row_draws(row0, n_rows, 1)[:, 0], lo, hi)


# --- weighted distributions (dists.dss) --------------------------------


class Dist:
    """Weighted value list; pick = rnd(0, total_weight-1) then first
    cumulative weight above the draw."""

    def __init__(self, pairs):
        self.values = [v for v, _ in pairs]
        w = np.asarray([wt for _, wt in pairs], dtype=np.int64)
        self.cum = np.cumsum(w)
        self.total = int(self.cum[-1])

    def pick(self, seeds: np.ndarray) -> np.ndarray:
        """Indices into ``values`` for each seed."""
        v = bounded(seeds, 0, self.total - 1)
        return np.searchsorted(self.cum, v, side="right").astype(np.int64)


SEGMENTS = Dist([(s, 1) for s in
                 ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]])
PRIORITIES = Dist([(s, 1) for s in
                   ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]])
INSTRUCTIONS = Dist([(s, 1) for s in
                     ["DELIVER IN PERSON", "COLLECT COD", "TAKE BACK RETURN", "NONE"]])
MODES = Dist([(s, 1) for s in
              ["REG AIR", "AIR", "RAIL", "TRUCK", "MAIL", "FOB", "SHIP"]])
RETURN_FLAGS = Dist([("R", 1), ("A", 1)])
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
TYPES = Dist([(f"{a} {b} {c}", 1) for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3])
CONTAINERS = Dist([
    (f"{a} {b}", 1)
    for a in ["SM", "LG", "MED", "JUMBO", "WRAP"]
    for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
])

COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki", "lace",
    "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya",
    "peach", "peru", "pink", "plum", "powder", "puff", "purple", "red",
    "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]

# --- stream seed constants ---------------------------------------------
# Verified (V) against reference fixtures or solved (S) from them by
# interval constraint propagation; see tests/test_dbgen.py.

S_ORDER_DATE = 1066728069  # V
S_LINE_COUNT = 1434868289  # V
S_CUST_KEY = 851767375  # V (with mortality adjustment)
S_ORDER_PRIORITY = 591449447  # V
S_CLERK = 1171034773  # V
S_ORDER_COMMENT = 276090261  # V (offset-first, avg len 49)

S_QUANTITY = 209208115  # S
S_DISCOUNT = 554590007  # V
S_TAX = 721958466  # V
S_LINE_PART_KEY = 1808217256  # V
S_SUPPLIER_NUMBER = 2095021727  # V
S_SHIP_DATE = 1769349045  # V
S_COMMIT_DATE = 904914315  # V
S_RECEIPT_DATE = 373135028  # V
S_RETURN_FLAG = 717419739  # V (conditional draw)
S_SHIP_INSTRUCT = 1371272478  # V (value order solved from fixtures)
S_SHIP_MODE = 675466456  # V (value order solved from fixtures)
S_LINE_COMMENT = 1095462486  # V (offset-first, avg len 27)

S_CUST_NATION = 1489529863
S_CUST_PHONE = 1521138112
S_CUST_ACCTBAL = 298370230
S_CUST_SEGMENT = 1140279430
S_CUST_COMMENT = 1335826707
S_CUST_ADDRESS = 881155353

S_SUPP_NATION = 110356601
S_SUPP_PHONE = 884434366
S_SUPP_ACCTBAL = 962338209
S_SUPP_COMMENT = 1341315363
S_SUPP_ADDRESS = 1900810743
S_SUPP_BBB_ROW = 202794285
S_SUPP_BBB_JUNK = 263032577
S_SUPP_BBB_OFFSET = 715851524
S_SUPP_BBB_TYPE = 132099341

S_PART_NAME = 709314158
S_PART_MFGR = 1
S_PART_BRAND = 46831694
S_PART_TYPE = 1841581359
S_PART_SIZE = 1193163244
S_PART_CONTAINER = 727633698
S_PART_COMMENT = 804159733

S_PS_AVAILQTY = 1671059989
S_PS_SUPPLYCOST = 1051288424
S_PS_COMMENT = 1961692154

S_NATION_COMMENT = 606179079
S_REGION_COMMENT = 1500869201

S_TEXT_POOL = 933588178


# --- key helpers --------------------------------------------------------


def make_order_key(index: np.ndarray) -> np.ndarray:
    """Sparse order keys (dbgen mk_sparse: 8 keys per 32-slot block)."""
    idx = np.asarray(index, dtype=np.int64)
    return ((idx >> 3) << 5) | (idx & 7)


def order_key_to_index(key: np.ndarray) -> np.ndarray:
    key = np.asarray(key, dtype=np.int64)
    return (key >> 5) * 8 + (key & 7)


def part_supplier(part_key: np.ndarray, supplier_number, supplier_count: int) -> np.ndarray:
    """The partsupp bridge (spec 4.2.5.4)."""
    pk = np.asarray(part_key, dtype=np.int64)
    sn = np.asarray(supplier_number, dtype=np.int64)
    return (
        (pk + sn * (supplier_count // 4 + (pk - 1) // supplier_count))
        % supplier_count
    ) + 1


def part_price(part_key: np.ndarray) -> np.ndarray:
    """p_retailprice in cents (spec 4.2.5.3)."""
    pk = np.asarray(part_key, dtype=np.int64)
    return 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1_000)


def adjust_customer_key(ck: np.ndarray, max_key: int) -> np.ndarray:
    """Customers divisible by 3 place no orders; dbgen nudges +1 then -1."""
    ck = ck.copy()
    dead = ck % CUSTOMER_MORTALITY == 0
    ck[dead] = np.minimum(ck[dead] + 1, max_key)
    dead = ck % CUSTOMER_MORTALITY == 0
    ck[dead] -= 1
    return ck


# --- order/lineitem generation (shared core) ---------------------------


#: gen_order_block feature flags per requested output; None = everything.
_ALL_FEATURES = frozenset(
    {
        "custkey", "orderdate", "priority", "clerk", "quantity", "discount",
        "tax", "partkey", "suppnum", "ship", "commit", "receipt", "rflag",
        "status", "instruct", "mode", "totalprice",
    }
)


def gen_order_block(sf: float, row0: int, n_rows: int, need=None):
    """Per-order columns + per-line matrices for orders [row0, row0+n).

    Returns a dict with order-level arrays (n,) and line-level (n, 7)
    matrices plus ``line_counts``; callers slice what they need. All
    integer money values are cents. ``need`` (a subset of _ALL_FEATURES)
    skips unneeded streams — stream independence means skipping one never
    shifts another.
    """
    need = _ALL_FEATURES if need is None else frozenset(need)
    # derived-value dependencies
    if "totalprice" in need:
        need |= {"quantity", "discount", "tax", "partkey"}
    if "status" in need or "rflag" in need:
        need |= {"ship"}
    if "rflag" in need:
        need |= {"receipt"}
    if "receipt" in need:
        need |= {"ship"}  # receipt date offsets from ship date
    c = counts(sf)
    out = {}
    out["order_index"] = np.arange(row0 + 1, row0 + n_rows + 1, dtype=np.int64)
    out["o_orderkey"] = make_order_key(out["order_index"])
    out["line_counts"] = Stream(S_LINE_COUNT, 1).rows(
        row0, n_rows, 1, LINES_PER_ORDER_MAX
    )
    L = LINES_PER_ORDER_MAX
    live = np.arange(L)[None, :] < out["line_counts"][:, None]
    out["live"] = live

    if "custkey" in need:
        ck = bounded(
            Stream(S_CUST_KEY, 1).row_draws(row0, n_rows)[:, 0],
            1,
            c["customer"],
        )
        out["o_custkey"] = adjust_customer_key(ck, c["customer"])
    if "orderdate" in need or "ship" in need or "commit" in need:
        out["o_orderdate_off"] = Stream(S_ORDER_DATE, 1).rows(
            row0, n_rows, 0, ORDER_DATE_RANGE - 1
        )
    if "priority" in need:
        out["o_priority_idx"] = PRIORITIES.pick(
            Stream(S_ORDER_PRIORITY, 1).row_draws(row0, n_rows)[:, 0]
        )
    if "clerk" in need:
        clerk_count = max(int(sf), 1) * CLERK_BASE
        out["o_clerk_num"] = Stream(S_CLERK, 1).rows(row0, n_rows, 1, clerk_count)

    if "quantity" in need:
        out["l_quantity"] = bounded(
            Stream(S_QUANTITY, L).row_draws(row0, n_rows, L), 1, 50
        )
    if "discount" in need:
        out["l_discount"] = bounded(
            Stream(S_DISCOUNT, L).row_draws(row0, n_rows, L), 0, 10
        )
    if "tax" in need:
        out["l_tax"] = bounded(Stream(S_TAX, L).row_draws(row0, n_rows, L), 0, 8)
    if "partkey" in need:
        out["l_partkey"] = bounded(
            Stream(S_LINE_PART_KEY, L).row_draws(row0, n_rows, L), 1, c["part"]
        )
    if "suppnum" in need:
        out["l_suppnum"] = bounded(
            Stream(S_SUPPLIER_NUMBER, L).row_draws(row0, n_rows, L), 0, 3
        )
    if "ship" in need:
        shipdays = bounded(
            Stream(S_SHIP_DATE, L).row_draws(row0, n_rows, L), 1, 121
        )
        out["l_ship_off"] = out["o_orderdate_off"][:, None] + shipdays
    if "commit" in need:
        commitdays = bounded(
            Stream(S_COMMIT_DATE, L).row_draws(row0, n_rows, L), 30, 90
        )
        out["l_commit_off"] = out["o_orderdate_off"][:, None] + commitdays
    if "receipt" in need:
        receiptdays = bounded(
            Stream(S_RECEIPT_DATE, L).row_draws(row0, n_rows, L), 1, 30
        )
        out["l_receipt_off"] = out["l_ship_off"] + receiptdays

    if "quantity" in need and "partkey" in need:
        out["l_eprice"] = out["l_quantity"] * part_price(out["l_partkey"])

    if "rflag" in need:
        # return flag: R/A drawn ONLY for lines already received
        # (conditional stream usage, resynced per order — verified)
        past = (out["l_receipt_off"] <= CURRENT_DATE_OFFSET) & live
        draw_idx = np.cumsum(past, axis=1) - 1
        rf_seeds = Stream(S_RETURN_FLAG, L).row_draws(row0, n_rows, L)
        flat_rows = np.arange(n_rows)[:, None].repeat(L, axis=1)
        rf_at = rf_seeds[flat_rows, np.clip(draw_idx, 0, L - 1)]
        rflag_idx = RETURN_FLAGS.pick(rf_at.reshape(-1)).reshape(n_rows, L)
        out["l_returnflag_idx"] = np.where(past, rflag_idx, 2)  # 2 => "N"
    if "ship" in need:
        out["l_linestatus_idx"] = (
            out["l_ship_off"] > CURRENT_DATE_OFFSET
        ).astype(np.int64)  # 1='O'

    if "instruct" in need:
        out["l_instruct_idx"] = INSTRUCTIONS.pick(
            Stream(S_SHIP_INSTRUCT, L).row_draws(row0, n_rows, L).reshape(-1)
        ).reshape(n_rows, L)
    if "mode" in need:
        out["l_mode_idx"] = MODES.pick(
            Stream(S_SHIP_MODE, L).row_draws(row0, n_rows, L).reshape(-1)
        ).reshape(n_rows, L)

    if "totalprice" in need:
        # o_totalprice: integer cents math exactly as dbgen computes it
        ep = out["l_eprice"]
        line_total = (
            (ep * (100 - out["l_discount"])) // 100 * (100 + out["l_tax"]) // 100
        )
        out["o_totalprice"] = np.where(live, line_total, 0).sum(axis=1)

    if "status" in need:
        # o_orderstatus: F if all lines shipped, O if none, else P
        shipped = (out["l_linestatus_idx"] == 0) & live
        n_shipped = shipped.sum(axis=1)
        out["o_status_idx"] = np.where(
            n_shipped == out["line_counts"], 0,
            np.where(n_shipped == 0, 1, 2),
        )  # 0='F', 1='O', 2='P'
    return out


# --- text pool ----------------------------------------------------------
# Grammar + word distributions reconstructed from the TPC-H spec's dists
# appendix; weights cross-checked against word frequencies in dbgen-
# produced fixture comments (tests/test_dbgen.py). The pool is the
# 300MB sentence stream every *_comment column slices into.

TEXT_POOL_SIZE = 300 * 1024 * 1024

GRAMMAR = [("N V T", 3), ("N V P T", 3), ("N V N T", 3),
           ("N P V N T", 1), ("N P V P T", 1)]
NOUN_PHRASE = [("N", 10), ("J N", 20), ("J, J N", 10), ("D J N", 50)]
VERB_PHRASE = [("V", 30), ("X V", 1), ("V D", 40), ("X V D", 1)]

NOUNS = [
    ("packages", 40), ("requests", 40), ("accounts", 40), ("deposits", 40),
    ("foxes", 20), ("ideas", 20), ("theodolites", 20), ("pinto beans", 20),
    ("instructions", 18), ("dependencies", 10), ("excuses", 10),
    ("platelets", 10), ("asymptotes", 10), ("courts", 5), ("dolphins", 5),
    ("multipliers", 1), ("sauternes", 1), ("warthogs", 1), ("frets", 1),
    ("dinos", 1), ("attainments", 1), ("somas", 1), ("Tiresias", 1),
    ("patterns", 1), ("forges", 1), ("braids", 1), ("hockey players", 1),
    ("frays", 1), ("warhorses", 1), ("dugouts", 1), ("notornis", 1),
    ("epitaphs", 1), ("pearls", 1), ("tithes", 1), ("waters", 1),
    ("orbits", 1), ("gifts", 1), ("sheaves", 1), ("depths", 1),
    ("sentiments", 1), ("decoys", 1), ("realms", 1), ("pains", 1),
    ("grouches", 1), ("escapades", 1),
]
VERBS = [
    ("sleep", 20), ("wake", 20), ("are", 20), ("cajole", 20), ("haggle", 20),
    ("nag", 10), ("use", 10), ("boost", 10), ("affix", 5), ("detect", 5),
    ("integrate", 5), ("maintain", 1), ("nod", 1), ("was", 1), ("lose", 1),
    ("sublate", 1), ("solve", 1), ("thrash", 1), ("promise", 1),
    ("engage", 1), ("hinder", 1), ("print", 1), ("x-ray", 1), ("breach", 1),
    ("eat", 1), ("grow", 1), ("impress", 1), ("mold", 1), ("poach", 1),
    ("serve", 1), ("run", 1), ("dazzle", 1), ("snooze", 1), ("doze", 1),
    ("unwind", 1), ("kindle", 1), ("play", 1), ("hang", 1), ("believe", 1),
    ("doubt", 1),
]
ADJECTIVES = [
    ("furious", 1), ("sly", 1), ("careful", 1), ("blithe", 1), ("quick", 1),
    ("fluffy", 1), ("slow", 1), ("quiet", 1), ("ruthless", 1), ("thin", 1),
    ("close", 1), ("dogged", 1), ("daring", 1), ("bright", 1),
    ("stealthy", 1), ("permanent", 1), ("enticing", 1), ("idle", 1),
    ("busy", 1), ("regular", 50), ("final", 40), ("ironic", 40),
    ("even", 20), ("bold", 20), ("silent", 10), ("special", 20),
    ("pending", 20), ("unusual", 20), ("express", 20),
]
ADVERBS = [
    ("sometimes", 1), ("always", 1), ("never", 1), ("furiously", 50),
    ("slyly", 50), ("carefully", 50), ("blithely", 40), ("quickly", 30),
    ("fluffily", 20), ("slowly", 1), ("quietly", 1), ("ruthlessly", 1),
    ("thinly", 1), ("closely", 1), ("doggedly", 1), ("daringly", 1),
    ("bravely", 1), ("stealthily", 1), ("permanently", 1), ("enticingly", 1),
    ("idly", 1), ("busily", 1), ("regularly", 1), ("finally", 1),
    ("ironically", 1), ("evenly", 1), ("boldly", 1), ("silently", 1),
]
PREPOSITIONS = [
    ("about", 50), ("above", 50), ("according to", 50), ("across", 50),
    ("after", 50), ("against", 40), ("along", 40), ("alongside of", 30),
    ("among", 30), ("around", 20), ("at", 10), ("atop", 1), ("before", 1),
    ("behind", 1), ("beneath", 1), ("beside", 1), ("besides", 1),
    ("between", 1), ("beyond", 1), ("by", 1), ("despite", 1), ("during", 1),
    ("except", 1), ("for", 1), ("from", 1), ("in place of", 1),
    ("inside", 1), ("instead of", 1), ("into", 1), ("near", 1), ("of", 1),
    ("on", 1), ("outside", 1), ("over", 1), ("past", 1), ("since", 1),
    ("through", 1), ("throughout", 1), ("to", 1), ("toward", 1),
    ("under", 1), ("until", 1), ("up", 1), ("upon", 1), ("whithout", 1),
    ("with", 1), ("within", 1),
]
AUXILIARIES = [
    ("do", 1), ("may", 1), ("might", 1), ("shall", 1), ("will", 1),
    ("would", 1), ("can", 1), ("could", 1), ("should", 1), ("ought to", 1),
    ("must", 1), ("will have to", 1), ("shall have to", 1),
    ("could have to", 1), ("should have to", 1), ("must have to", 1),
    ("need to", 1), ("try to", 1),
]
TERMINATORS = [(".", 50), (";", 1), (":", 1), ("?", 1), ("!", 1), ("--", 1)]

_TEXT_DISTS = [GRAMMAR, NOUN_PHRASE, VERB_PHRASE, NOUNS, VERBS, ADJECTIVES,
               ADVERBS, PREPOSITIONS, AUXILIARIES, TERMINATORS]


def dists_blob() -> bytes:
    import struct

    parts = []
    for dist in _TEXT_DISTS:
        parts.append(struct.pack("<i", len(dist)))
        for value, weight in dist:
            b = value.encode()
            parts.append(struct.pack("<ii", weight, len(b)))
            parts.append(b)
    return b"".join(parts)


def textpool_python(size: int, blob: bytes, seed: int) -> np.ndarray:
    """Pure-Python fallback mirroring tt_tpch_textpool (slow; one-time)."""
    import struct

    dists = []
    p = 0
    for _ in range(10):
        (n,) = struct.unpack_from("<i", blob, p)
        p += 4
        entries = []
        for _ in range(n):
            w, ln = struct.unpack_from("<ii", blob, p)
            p += 8
            entries.append((blob[p : p + ln].decode(), w))
            p += ln
        dists.append(Dist(entries))
    grammar, np_d, vp_d, nouns, verbs, adjs, advs, preps, auxs, terms = dists
    words = {"N": nouns, "V": verbs, "J": adjs, "D": advs, "X": auxs}

    state = {"seed": seed}

    def rnd(lo, hi):
        state["seed"] = (state["seed"] * A) % M
        return lo + int((1.0 * state["seed"] / M) * (hi - lo + 1))

    def pick(d: Dist) -> str:
        v = rnd(0, d.total - 1)
        return d.values[int(np.searchsorted(d.cum, v, side="right"))]

    out = bytearray()

    def phrase(syntax_dist):
        for ch in pick(syntax_dist):
            if ch == ",":
                out.append(0x2C)
            elif ch == " ":
                out.append(0x20)
            else:
                out.extend(pick(words[ch]).encode())

    while len(out) < size:
        syntax = pick(grammar)
        for i in range(0, len(syntax), 2):
            tok = syntax[i]
            if tok == "V":
                phrase(vp_d)
            elif tok == "N":
                phrase(np_d)
            elif tok == "P":
                out.extend(pick(preps).encode())
                out.extend(b" the ")
                phrase(np_d)
            elif tok == "T":
                if out:
                    out.pop()
                out.extend(pick(terms).encode())
            if not out or out[-1] != 0x20:
                out.append(0x20)
    return np.frombuffer(bytes(out[:size]), dtype=np.uint8)


def text_pool() -> np.ndarray:
    """The 300MB comment text pool. It is built by the native loader,
    which is not ported yet (the reference memory-maps a disk-cached copy
    built by ``trino_tpu.native``); the pure-Python version
    (:func:`textpool_python`) takes minutes, so it is never used as a
    stand-in. Every comment column raises until the loader lands."""
    raise NotImplementedError(
        "TPC-H comment columns need the 300 MB text pool, which waits for "
        "the native loader (ROADMAP Queue 1 item 4)"
    )


def text_column(stream: Stream, row0: int, n_rows: int, avg_len: int,
                uses: int = 1) -> list[str]:
    """Comments: offset draw then length draw per use (verified order)."""
    lo = int(avg_len * 0.4)
    hi = int(avg_len * 1.6)
    pool = text_pool()
    draws = stream.row_draws(row0, n_rows, 2 * uses)
    offs = bounded(draws[:, 0::2].reshape(-1), 0, TEXT_POOL_SIZE - hi)
    lens = bounded(draws[:, 1::2].reshape(-1), lo, hi)
    out = []
    for o, ln in zip(offs.tolist(), lens.tolist()):
        out.append(pool[o : o + ln].tobytes().decode("ascii"))
    return out


# --- remaining column helpers ------------------------------------------

ALPHA_NUMERIC = "0123456789abcdefghijklmnopqrstuvwxyz, ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def alnum_column(stream: Stream, row0: int, n_rows: int) -> list[str]:
    """v_str addresses: length draw then one packed draw per 5 chars.

    KNOWN DEVIATION: lengths and ~80% of characters match the reference
    fixtures; the exact float path of the reference's 5-char packing is
    still being reverse-engineered (tests pin the current behavior).
    """
    draws = stream.row_draws(row0, n_rows, 9)
    lens = bounded(draws[:, 0], 10, 40)
    out = []
    for r in range(n_rows):
        L = int(lens[r])
        chars = []
        v = 0
        for i in range(L):
            if i % 5 == 0:
                v = (1 << 31) + 1 - int(draws[r, 1 + i // 5])
            chars.append(ALPHA_NUMERIC[v % 64])
            v //= 64
        out.append("".join(chars))
    return out


def phone_column(stream: Stream, row0: int, n_rows: int,
                 nation_key: np.ndarray) -> list[str]:
    draws = stream.row_draws(row0, n_rows, 3)
    d1 = bounded(draws[:, 0], 100, 999)
    d2 = bounded(draws[:, 1], 100, 999)
    d3 = bounded(draws[:, 2], 1000, 9999)
    cc = nation_key + 10
    return [
        f"{int(c):02d}-{int(a):03d}-{int(b):03d}-{int(x):04d}"
        for c, a, b, x in zip(cc, d1, d2, d3)
    ]


# --- part name permutation (sequential state) ---------------------------


class _ColorPermutation:
    """dbgen's persistent partial Fisher-Yates over the 92 color words:
    each part row applies 5 swaps (swap i <-> rnd(i, 91)) to a table that
    is NEVER reset, then reads the first 5 entries. Sequential by nature;
    checkpoints every CHECKPOINT_ROWS rows bound replay for random access,
    and a lock guards the shared state (read_split runs on server
    threads)."""

    CHECKPOINT_ROWS = 1 << 16

    def __init__(self):
        import threading

        self.state = np.arange(len(COLORS), dtype=np.int64)
        self.row = 0
        self._checkpoints: dict[int, np.ndarray] = {0: self.state.copy()}
        self._lock = threading.Lock()

    def _restore_nearest(self, row: int) -> None:
        best = max((r for r in self._checkpoints if r <= row), default=0)
        if best <= self.row <= row:
            return  # current state is at least as close as any checkpoint
        self.state = self._checkpoints[best].copy()
        self.row = best

    def _apply(self, row0: int, n: int, collect: bool):
        draws = Stream(S_PART_NAME, 5).row_draws(row0, n, 5)
        swaps = np.empty((n, 5), dtype=np.int64)
        for i in range(5):
            swaps[:, i] = bounded(draws[:, i], i, len(COLORS) - 1)
        out = [] if collect else None
        st = self.state
        cp = self.CHECKPOINT_ROWS
        for r in range(n):
            for i in range(5):
                j = swaps[r, i]
                st[i], st[j] = st[j], st[i]
            row = row0 + r + 1
            if row % cp == 0 and row not in self._checkpoints:
                self._checkpoints[row] = st.copy()
            if collect:
                out.append(" ".join(COLORS[int(st[i])] for i in range(5)))
        self.row = row0 + n
        return out

    def names(self, row0: int, n_rows: int) -> list[str]:
        with self._lock:
            if row0 != self.row:
                self._restore_nearest(row0)
                if self.row < row0:
                    self._apply(self.row, row0 - self.row, collect=False)
            return self._apply(row0, n_rows, collect=True)


_color_perm = _ColorPermutation()


# --- table generators ---------------------------------------------------


def gen_region(row0: int, n: int) -> dict:
    keys = np.arange(row0, row0 + n, dtype=np.int64)
    return {
        "r_regionkey": keys,
        "r_name": keys.copy(),  # code == key
        "r_comment": text_column(Stream(S_REGION_COMMENT, 2), row0, n, 72),
    }


def gen_nation(row0: int, n: int) -> dict:
    keys = np.arange(row0, row0 + n, dtype=np.int64)
    return {
        "n_nationkey": keys,
        "n_name": keys.copy(),  # code == key
        "n_regionkey": np.asarray(
            [NATIONS[int(k)][1] for k in keys], dtype=np.int64
        ),
        "n_comment": text_column(Stream(S_NATION_COMMENT, 2), row0, n, 72),
    }


def gen_supplier(sf: float, row0: int, n: int, want=None) -> dict:
    def w(c):
        return want is None or c in want

    keys = np.arange(row0 + 1, row0 + n + 1, dtype=np.int64)
    nation = Stream(S_SUPP_NATION, 1).rows(row0, n, 0, 24)
    comments = (
        text_column(Stream(S_SUPP_COMMENT, 2), row0, n, 63)
        if w("s_comment")
        else None
    )
    # BBB: ~10 per 10,000 suppliers carry a Better-Business-Bureau note
    sel = Stream(S_SUPP_BBB_ROW, 1).rows(row0, n, 1, SUPPLIER_BASE)
    chosen = np.nonzero(sel <= 10)[0]
    if comments is not None and len(chosen):
        base = "Customer "
        for r in chosen.tolist():
            c = comments[r]
            ctype = int(Stream(S_SUPP_BBB_TYPE, 1).rows(row0 + r, 1, 0, 100)[0])
            word = "Complaints" if ctype < 50 else "Recommends"
            total = len(base) + len(word)
            junk = int(
                Stream(S_SUPP_BBB_JUNK, 1).rows(row0 + r, 1, 0, len(c) - total)[0]
            )
            off = int(
                Stream(S_SUPP_BBB_OFFSET, 1).rows(
                    row0 + r, 1, 0, len(c) - (total + junk)
                )[0]
            )
            comments[r] = (
                c[:off]
                + base
                + c[off + len(base) : off + len(base) + junk]
                + word
                + c[off + total + junk :]
            )
    out = {
        "s_suppkey": keys,
        "s_nationkey": nation,
        "s_acctbal": Stream(S_SUPP_ACCTBAL, 1).rows(row0, n, -99_999, 999_999),
    }
    if w("s_name"):
        out["s_name"] = [f"Supplier#{int(k):09d}" for k in keys]
    if w("s_address"):
        out["s_address"] = alnum_column(Stream(S_SUPP_ADDRESS, 9), row0, n)
    if w("s_phone"):
        out["s_phone"] = phone_column(Stream(S_SUPP_PHONE, 3), row0, n, nation)
    if comments is not None:
        out["s_comment"] = comments
    return out


def gen_customer(sf: float, row0: int, n: int, want=None) -> dict:
    def w(c):
        return want is None or c in want

    keys = np.arange(row0 + 1, row0 + n + 1, dtype=np.int64)
    nation = Stream(S_CUST_NATION, 1).rows(row0, n, 0, 24)
    seg_idx = SEGMENTS.pick(Stream(S_CUST_SEGMENT, 1).row_draws(row0, n)[:, 0])
    out = {
        "c_custkey": keys,
        "c_nationkey": nation,
        "c_acctbal": Stream(S_CUST_ACCTBAL, 1).rows(row0, n, -99_999, 999_999),
        "c_mktsegment": seg_idx,
    }
    if w("c_name"):
        out["c_name"] = [f"Customer#{int(k):09d}" for k in keys]
    if w("c_address"):
        out["c_address"] = alnum_column(Stream(S_CUST_ADDRESS, 9), row0, n)
    if w("c_phone"):
        out["c_phone"] = phone_column(Stream(S_CUST_PHONE, 3), row0, n, nation)
    if w("c_comment"):
        out["c_comment"] = text_column(Stream(S_CUST_COMMENT, 2), row0, n, 73)
    return out


def gen_part(sf: float, row0: int, n: int, want=None) -> dict:
    def w(c):
        return want is None or c in want

    keys = np.arange(row0 + 1, row0 + n + 1, dtype=np.int64)
    mfgr = Stream(S_PART_MFGR, 1).rows(row0, n, 1, 5)
    brand = Stream(S_PART_BRAND, 1).rows(row0, n, 1, 5)
    type_idx = TYPES.pick(Stream(S_PART_TYPE, 1).row_draws(row0, n)[:, 0])
    cont_idx = CONTAINERS.pick(
        Stream(S_PART_CONTAINER, 1).row_draws(row0, n)[:, 0]
    )
    out = {
        "p_partkey": keys,
        "p_mfgr": mfgr - 1,  # code 0..4 -> Manufacturer#1..5
        "p_brand": (mfgr - 1) * 5 + (brand - 1),  # code -> Brand#{m}{b}
        "p_type": type_idx,
        "p_size": Stream(S_PART_SIZE, 1).rows(row0, n, 1, 50),
        "p_container": cont_idx,
        "p_retailprice": part_price(keys),
    }
    if w("p_name"):
        out["p_name"] = _color_perm.names(row0, n)
    if w("p_comment"):
        out["p_comment"] = text_column(Stream(S_PART_COMMENT, 2), row0, n, 14)
    return out


def gen_partsupp(sf: float, part_row0: int, n_parts: int, want=None) -> dict:
    def w(c):
        return want is None or c in want

    c = counts(sf)
    pkeys = np.arange(part_row0 + 1, part_row0 + n_parts + 1, dtype=np.int64)
    pk4 = np.repeat(pkeys, SUPPLIERS_PER_PART)
    sn = np.tile(
        np.arange(SUPPLIERS_PER_PART, dtype=np.int64), n_parts
    )
    qty = bounded(
        Stream(S_PS_AVAILQTY, SUPPLIERS_PER_PART).row_draws(
            part_row0, n_parts, SUPPLIERS_PER_PART
        ).reshape(-1),
        1,
        9_999,
    )
    cost = bounded(
        Stream(S_PS_SUPPLYCOST, SUPPLIERS_PER_PART).row_draws(
            part_row0, n_parts, SUPPLIERS_PER_PART
        ).reshape(-1),
        100,
        100_000,
    )
    return {
        "ps_partkey": pk4,
        "ps_suppkey": part_supplier(pk4, sn, c["supplier"]),
        "ps_availqty": qty,
        "ps_supplycost": cost,
        **(
            {
                "ps_comment": text_column(
                    Stream(S_PS_COMMENT, 2 * SUPPLIERS_PER_PART),
                    part_row0,
                    n_parts,
                    124,
                    uses=SUPPLIERS_PER_PART,
                )
            }
            if w("ps_comment")
            else {}
        ),
    }


_ORDER_FEATURES = {
    "o_custkey": {"custkey"},
    "o_orderstatus": {"status"},
    "o_totalprice": {"totalprice"},
    "o_orderdate": {"orderdate"},
    "o_orderpriority": {"priority"},
    "o_clerk": {"clerk"},
}


def gen_orders(sf: float, row0: int, n: int, want=None) -> dict:
    def w(c):
        return want is None or c in want

    need = None
    if want is not None:
        need = set()
        for col, feats in _ORDER_FEATURES.items():
            if col in want:
                need |= feats
    blk = gen_order_block(sf, row0, n, need=need)
    out = {"o_orderkey": blk["o_orderkey"]}
    if w("o_custkey"):
        out["o_custkey"] = blk["o_custkey"]
    if w("o_orderstatus"):
        out["o_orderstatus"] = blk["o_status_idx"]
    if w("o_totalprice"):
        out["o_totalprice"] = blk["o_totalprice"]
    if w("o_orderdate"):
        out["o_orderdate"] = blk["o_orderdate_off"]
    if w("o_orderpriority"):
        out["o_orderpriority"] = blk["o_priority_idx"]
    if w("o_shippriority"):
        out["o_shippriority"] = np.zeros(n, dtype=np.int64)
    if w("o_clerk"):
        out["o_clerk"] = [
            f"Clerk#{int(x):09d}" for x in blk["o_clerk_num"]
        ]
    if w("o_comment"):
        out["o_comment"] = text_column(Stream(S_ORDER_COMMENT, 2), row0, n, 49)
    return out


_LINE_FEATURES = {
    "l_partkey": {"partkey"},
    "l_suppkey": {"partkey", "suppnum"},
    "l_quantity": {"quantity"},
    "l_extendedprice": {"quantity", "partkey"},
    "l_discount": {"discount"},
    "l_tax": {"tax"},
    "l_returnflag": {"rflag"},
    "l_linestatus": {"ship"},
    "l_shipdate": {"ship"},
    "l_commitdate": {"commit"},
    "l_receiptdate": {"receipt"},
    "l_shipinstruct": {"instruct"},
    "l_shipmode": {"mode"},
}


def gen_lineitem(sf: float, order_row0: int, n_orders: int, want=None) -> dict:
    def w(c):
        return want is None or c in want

    c = counts(sf)
    need = None
    if want is not None:
        need = set()
        for col, feats in _LINE_FEATURES.items():
            if col in want:
                need |= feats
    blk = gen_order_block(sf, order_row0, n_orders, need=need)
    live = blk["live"]
    flat = np.nonzero(live.reshape(-1))[0]

    def take(mat):
        return mat.reshape(-1)[flat]

    L = LINES_PER_ORDER_MAX
    okeys = np.repeat(blk["o_orderkey"], L).reshape(-1)[flat]
    linenos = np.tile(np.arange(1, L + 1, dtype=np.int64), n_orders)[flat]
    out = {
        "l_orderkey": okeys,
        "l_linenumber": linenos,
        "_line_flat": flat,
        "_n_orders": n_orders,
    }
    if w("l_partkey"):
        out["l_partkey"] = take(blk["l_partkey"])
    if w("l_suppkey"):
        out["l_suppkey"] = part_supplier(
            take(blk["l_partkey"]), take(blk["l_suppnum"]), c["supplier"]
        )
    if w("l_quantity"):
        out["l_quantity"] = take(blk["l_quantity"]) * 100  # cents scale-2
    if w("l_extendedprice"):
        out["l_extendedprice"] = take(blk["l_eprice"])
    if w("l_discount"):
        out["l_discount"] = take(blk["l_discount"])
    if w("l_tax"):
        out["l_tax"] = take(blk["l_tax"])
    if w("l_returnflag"):
        out["l_returnflag"] = take(blk["l_returnflag_idx"])
    if w("l_linestatus"):
        out["l_linestatus"] = take(blk["l_linestatus_idx"])
    if w("l_shipdate"):
        out["l_shipdate"] = take(blk["l_ship_off"])
    if w("l_commitdate"):
        out["l_commitdate"] = take(blk["l_commit_off"])
    if w("l_receiptdate"):
        out["l_receiptdate"] = take(blk["l_receipt_off"])
    if w("l_shipinstruct"):
        out["l_shipinstruct"] = take(blk["l_instruct_idx"])
    if w("l_shipmode"):
        out["l_shipmode"] = take(blk["l_mode_idx"])
    return out


def lineitem_comments(order_row0: int, n_orders: int, flat: np.ndarray) -> list[str]:
    all_comments = text_column(
        Stream(S_LINE_COMMENT, 2 * LINES_PER_ORDER_MAX),
        order_row0,
        n_orders,
        27,
        uses=LINES_PER_ORDER_MAX,
    )
    return [all_comments[i] for i in flat.tolist()]


# Columns whose generator output is a small-int CODE into a fixed value
# list (tpch.py attaches one stable engine Dictionary per column).
DIST_VALUES = {
    "r_name": REGIONS,
    "n_name": [nm for nm, _ in NATIONS],
    "c_mktsegment": SEGMENTS.values,
    "p_mfgr": [f"Manufacturer#{i}" for i in range(1, 6)],
    "p_brand": [f"Brand#{m}{b}" for m in range(1, 6) for b in range(1, 6)],
    "p_type": TYPES.values,
    "p_container": CONTAINERS.values,
    "o_orderstatus": ["F", "O", "P"],
    "o_orderpriority": PRIORITIES.values,
    "l_returnflag": ["R", "A", "N"],
    "l_linestatus": ["F", "O"],
    "l_shipinstruct": INSTRUCTIONS.values,
    "l_shipmode": MODES.values,
}
