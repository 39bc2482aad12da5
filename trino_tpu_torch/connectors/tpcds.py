"""TPC-DS connector: deterministic on-the-fly columnar data generation.

Reference: ``plugin/trino-tpcds`` — synthetic TPC-DS tables generated per
split (no storage). The port's copy of ``trino_tpu/connectors/tpcds.py``:
the same schemas, statistics, splits and values, as host batches of CPU
tensors. Generated splits are kept in a host LRU cache and, as in the
reference, on disk (``connectors/diskcache.py``). All 24 schema tables
are present with spec row-count scaling; column sets cover the keys, measures, and descriptive attributes
used by the TPC-DS query corpus (notably the BASELINE configs' Q64/Q95
families). Like the tpch connector, exact per-row values are our own
deterministic keyed-hash streams — the engine's oracle recomputes expected
results from the same generated data.

Referential structure honored:
  - fact foreign keys land in the matching dimension key ranges
  - returns are a deterministic ~10% subset of their sales table, sharing
    (item_sk, ticket/order number) so sales-returns joins behave like the
    spec's (Q64's ss/sr join, Q95's ws/wr order-number semijoin)
  - date_dim spans 1998-01-01..2003-12-31 with consistent d_year/d_moy/d_dom
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.civil import days_from_civil
from trino_tpu_torch.columnar import Batch, Column, Dictionary, as_tensor
from trino_tpu_torch.connectors.api import (
    ColumnSchema,
    Connector,
    DeviceColumnStore,
    Split,
    TableSchema,
)
from trino_tpu_torch.connectors.diskcache import DbgenDiskCache

DEC = T.decimal(7, 2)

# === schemas (column subsets: keys + measures + hot descriptive attrs) =====

_SCHEMAS: dict[str, list[tuple[str, T.SqlType]]] = {
    "date_dim": [
        ("d_date_sk", T.BIGINT), ("d_date_id", T.VARCHAR), ("d_date", T.DATE),
        ("d_month_seq", T.BIGINT), ("d_week_seq", T.BIGINT),
        ("d_quarter_seq", T.BIGINT), ("d_year", T.BIGINT), ("d_dow", T.BIGINT),
        ("d_moy", T.BIGINT), ("d_dom", T.BIGINT), ("d_qoy", T.BIGINT),
        ("d_fy_year", T.BIGINT), ("d_day_name", T.VARCHAR),
        ("d_holiday", T.VARCHAR), ("d_weekend", T.VARCHAR),
    ],
    "time_dim": [
        ("t_time_sk", T.BIGINT), ("t_time_id", T.VARCHAR), ("t_time", T.BIGINT),
        ("t_hour", T.BIGINT), ("t_minute", T.BIGINT), ("t_second", T.BIGINT),
        ("t_am_pm", T.VARCHAR), ("t_shift", T.VARCHAR),
    ],
    "item": [
        ("i_item_sk", T.BIGINT), ("i_item_id", T.VARCHAR),
        ("i_item_desc", T.VARCHAR), ("i_current_price", DEC),
        ("i_wholesale_cost", DEC), ("i_brand_id", T.BIGINT),
        ("i_brand", T.VARCHAR), ("i_class_id", T.BIGINT),
        ("i_class", T.VARCHAR), ("i_category_id", T.BIGINT),
        ("i_category", T.VARCHAR), ("i_manufact_id", T.BIGINT),
        ("i_manufact", T.VARCHAR), ("i_size", T.VARCHAR),
        ("i_color", T.VARCHAR), ("i_units", T.VARCHAR),
        ("i_product_name", T.VARCHAR),
    ],
    "customer": [
        ("c_customer_sk", T.BIGINT), ("c_customer_id", T.VARCHAR),
        ("c_current_cdemo_sk", T.BIGINT), ("c_current_hdemo_sk", T.BIGINT),
        ("c_current_addr_sk", T.BIGINT), ("c_first_shipto_date_sk", T.BIGINT),
        ("c_first_sales_date_sk", T.BIGINT), ("c_first_name", T.VARCHAR),
        ("c_last_name", T.VARCHAR), ("c_birth_year", T.BIGINT),
        ("c_birth_country", T.VARCHAR), ("c_email_address", T.VARCHAR),
    ],
    "customer_address": [
        ("ca_address_sk", T.BIGINT), ("ca_address_id", T.VARCHAR),
        ("ca_street_number", T.VARCHAR), ("ca_street_name", T.VARCHAR),
        ("ca_city", T.VARCHAR), ("ca_county", T.VARCHAR),
        ("ca_state", T.VARCHAR), ("ca_zip", T.VARCHAR),
        ("ca_country", T.VARCHAR), ("ca_gmt_offset", DEC),
        ("ca_location_type", T.VARCHAR),
    ],
    "customer_demographics": [
        ("cd_demo_sk", T.BIGINT), ("cd_gender", T.VARCHAR),
        ("cd_marital_status", T.VARCHAR), ("cd_education_status", T.VARCHAR),
        ("cd_purchase_estimate", T.BIGINT), ("cd_credit_rating", T.VARCHAR),
        ("cd_dep_count", T.BIGINT),
    ],
    "household_demographics": [
        ("hd_demo_sk", T.BIGINT), ("hd_income_band_sk", T.BIGINT),
        ("hd_buy_potential", T.VARCHAR), ("hd_dep_count", T.BIGINT),
        ("hd_vehicle_count", T.BIGINT),
    ],
    "income_band": [
        ("ib_income_band_sk", T.BIGINT), ("ib_lower_bound", T.BIGINT),
        ("ib_upper_bound", T.BIGINT),
    ],
    "store": [
        ("s_store_sk", T.BIGINT), ("s_store_id", T.VARCHAR),
        ("s_store_name", T.VARCHAR), ("s_number_employees", T.BIGINT),
        ("s_floor_space", T.BIGINT), ("s_hours", T.VARCHAR),
        ("s_manager", T.VARCHAR), ("s_market_id", T.BIGINT),
        ("s_city", T.VARCHAR), ("s_county", T.VARCHAR),
        ("s_state", T.VARCHAR), ("s_zip", T.VARCHAR),
    ],
    "warehouse": [
        ("w_warehouse_sk", T.BIGINT), ("w_warehouse_id", T.VARCHAR),
        ("w_warehouse_name", T.VARCHAR), ("w_warehouse_sq_ft", T.BIGINT),
        ("w_city", T.VARCHAR), ("w_state", T.VARCHAR),
        ("w_country", T.VARCHAR),
    ],
    "ship_mode": [
        ("sm_ship_mode_sk", T.BIGINT), ("sm_ship_mode_id", T.VARCHAR),
        ("sm_type", T.VARCHAR), ("sm_code", T.VARCHAR),
        ("sm_carrier", T.VARCHAR),
    ],
    "reason": [
        ("r_reason_sk", T.BIGINT), ("r_reason_id", T.VARCHAR),
        ("r_reason_desc", T.VARCHAR),
    ],
    "promotion": [
        ("p_promo_sk", T.BIGINT), ("p_promo_id", T.VARCHAR),
        ("p_start_date_sk", T.BIGINT), ("p_end_date_sk", T.BIGINT),
        ("p_item_sk", T.BIGINT), ("p_cost", DEC),
        ("p_channel_dmail", T.VARCHAR), ("p_channel_email", T.VARCHAR),
        ("p_channel_tv", T.VARCHAR), ("p_promo_name", T.VARCHAR),
    ],
    "web_site": [
        ("web_site_sk", T.BIGINT), ("web_site_id", T.VARCHAR),
        ("web_name", T.VARCHAR), ("web_manager", T.VARCHAR),
        ("web_company_name", T.VARCHAR), ("web_state", T.VARCHAR),
    ],
    "web_page": [
        ("wp_web_page_sk", T.BIGINT), ("wp_web_page_id", T.VARCHAR),
        ("wp_url", T.VARCHAR), ("wp_type", T.VARCHAR),
        ("wp_char_count", T.BIGINT), ("wp_link_count", T.BIGINT),
    ],
    "call_center": [
        ("cc_call_center_sk", T.BIGINT), ("cc_call_center_id", T.VARCHAR),
        ("cc_name", T.VARCHAR), ("cc_class", T.VARCHAR),
        ("cc_employees", T.BIGINT), ("cc_manager", T.VARCHAR),
        ("cc_county", T.VARCHAR), ("cc_state", T.VARCHAR),
    ],
    "catalog_page": [
        ("cp_catalog_page_sk", T.BIGINT), ("cp_catalog_page_id", T.VARCHAR),
        ("cp_department", T.VARCHAR), ("cp_catalog_number", T.BIGINT),
        ("cp_catalog_page_number", T.BIGINT), ("cp_type", T.VARCHAR),
    ],
    "inventory": [
        ("inv_date_sk", T.BIGINT), ("inv_item_sk", T.BIGINT),
        ("inv_warehouse_sk", T.BIGINT), ("inv_quantity_on_hand", T.BIGINT),
    ],
    "store_sales": [
        ("ss_sold_date_sk", T.BIGINT), ("ss_sold_time_sk", T.BIGINT),
        ("ss_item_sk", T.BIGINT), ("ss_customer_sk", T.BIGINT),
        ("ss_cdemo_sk", T.BIGINT), ("ss_hdemo_sk", T.BIGINT),
        ("ss_addr_sk", T.BIGINT), ("ss_store_sk", T.BIGINT),
        ("ss_promo_sk", T.BIGINT), ("ss_ticket_number", T.BIGINT),
        ("ss_quantity", T.BIGINT), ("ss_wholesale_cost", DEC),
        ("ss_list_price", DEC), ("ss_sales_price", DEC),
        ("ss_ext_discount_amt", DEC), ("ss_ext_sales_price", DEC),
        ("ss_ext_wholesale_cost", DEC), ("ss_ext_list_price", DEC),
        ("ss_ext_tax", DEC), ("ss_coupon_amt", DEC),
        ("ss_net_paid", DEC), ("ss_net_paid_inc_tax", DEC),
        ("ss_net_profit", DEC),
    ],
    "store_returns": [
        ("sr_returned_date_sk", T.BIGINT), ("sr_return_time_sk", T.BIGINT),
        ("sr_item_sk", T.BIGINT), ("sr_customer_sk", T.BIGINT),
        ("sr_cdemo_sk", T.BIGINT), ("sr_hdemo_sk", T.BIGINT),
        ("sr_addr_sk", T.BIGINT), ("sr_store_sk", T.BIGINT),
        ("sr_reason_sk", T.BIGINT), ("sr_ticket_number", T.BIGINT),
        ("sr_return_quantity", T.BIGINT), ("sr_return_amt", DEC),
        ("sr_return_tax", DEC), ("sr_return_amt_inc_tax", DEC),
        ("sr_fee", DEC), ("sr_return_ship_cost", DEC),
        ("sr_refunded_cash", DEC), ("sr_reversed_charge", DEC),
        ("sr_store_credit", DEC), ("sr_net_loss", DEC),
    ],
    "catalog_sales": [
        ("cs_sold_date_sk", T.BIGINT), ("cs_sold_time_sk", T.BIGINT),
        ("cs_ship_date_sk", T.BIGINT), ("cs_bill_customer_sk", T.BIGINT),
        ("cs_bill_cdemo_sk", T.BIGINT), ("cs_bill_hdemo_sk", T.BIGINT),
        ("cs_bill_addr_sk", T.BIGINT), ("cs_ship_customer_sk", T.BIGINT),
        ("cs_ship_addr_sk", T.BIGINT), ("cs_call_center_sk", T.BIGINT),
        ("cs_catalog_page_sk", T.BIGINT), ("cs_ship_mode_sk", T.BIGINT),
        ("cs_warehouse_sk", T.BIGINT), ("cs_item_sk", T.BIGINT),
        ("cs_promo_sk", T.BIGINT), ("cs_order_number", T.BIGINT),
        ("cs_quantity", T.BIGINT), ("cs_wholesale_cost", DEC),
        ("cs_list_price", DEC), ("cs_sales_price", DEC),
        ("cs_ext_discount_amt", DEC), ("cs_ext_sales_price", DEC),
        ("cs_ext_wholesale_cost", DEC), ("cs_ext_list_price", DEC),
        ("cs_ext_tax", DEC), ("cs_coupon_amt", DEC),
        ("cs_ext_ship_cost", DEC), ("cs_net_paid", DEC),
        ("cs_net_paid_inc_tax", DEC), ("cs_net_paid_inc_ship", DEC),
        ("cs_net_paid_inc_ship_tax", DEC), ("cs_net_profit", DEC),
    ],
    "catalog_returns": [
        ("cr_returned_date_sk", T.BIGINT), ("cr_returned_time_sk", T.BIGINT),
        ("cr_item_sk", T.BIGINT), ("cr_refunded_customer_sk", T.BIGINT),
        ("cr_refunded_addr_sk", T.BIGINT),
        ("cr_returning_customer_sk", T.BIGINT),
        ("cr_call_center_sk", T.BIGINT), ("cr_catalog_page_sk", T.BIGINT),
        ("cr_ship_mode_sk", T.BIGINT), ("cr_warehouse_sk", T.BIGINT),
        ("cr_reason_sk", T.BIGINT), ("cr_order_number", T.BIGINT),
        ("cr_return_quantity", T.BIGINT), ("cr_return_amount", DEC),
        ("cr_return_tax", DEC), ("cr_return_amt_inc_tax", DEC),
        ("cr_fee", DEC), ("cr_return_ship_cost", DEC),
        ("cr_refunded_cash", DEC), ("cr_reversed_charge", DEC),
        ("cr_store_credit", DEC), ("cr_net_loss", DEC),
    ],
    "web_sales": [
        ("ws_sold_date_sk", T.BIGINT), ("ws_sold_time_sk", T.BIGINT),
        ("ws_ship_date_sk", T.BIGINT), ("ws_item_sk", T.BIGINT),
        ("ws_bill_customer_sk", T.BIGINT), ("ws_bill_cdemo_sk", T.BIGINT),
        ("ws_bill_hdemo_sk", T.BIGINT), ("ws_bill_addr_sk", T.BIGINT),
        ("ws_ship_customer_sk", T.BIGINT), ("ws_ship_addr_sk", T.BIGINT),
        ("ws_web_page_sk", T.BIGINT), ("ws_web_site_sk", T.BIGINT),
        ("ws_ship_mode_sk", T.BIGINT), ("ws_warehouse_sk", T.BIGINT),
        ("ws_promo_sk", T.BIGINT), ("ws_order_number", T.BIGINT),
        ("ws_quantity", T.BIGINT), ("ws_wholesale_cost", DEC),
        ("ws_list_price", DEC), ("ws_sales_price", DEC),
        ("ws_ext_discount_amt", DEC), ("ws_ext_sales_price", DEC),
        ("ws_ext_wholesale_cost", DEC), ("ws_ext_list_price", DEC),
        ("ws_ext_tax", DEC), ("ws_coupon_amt", DEC),
        ("ws_ext_ship_cost", DEC), ("ws_net_paid", DEC),
        ("ws_net_paid_inc_tax", DEC), ("ws_net_paid_inc_ship", DEC),
        ("ws_net_paid_inc_ship_tax", DEC), ("ws_net_profit", DEC),
    ],
    "web_returns": [
        ("wr_returned_date_sk", T.BIGINT), ("wr_returned_time_sk", T.BIGINT),
        ("wr_item_sk", T.BIGINT), ("wr_refunded_customer_sk", T.BIGINT),
        ("wr_refunded_addr_sk", T.BIGINT),
        ("wr_returning_customer_sk", T.BIGINT),
        ("wr_web_page_sk", T.BIGINT), ("wr_reason_sk", T.BIGINT),
        ("wr_order_number", T.BIGINT), ("wr_return_quantity", T.BIGINT),
        ("wr_return_amt", DEC), ("wr_return_tax", DEC),
        ("wr_return_amt_inc_tax", DEC), ("wr_fee", DEC),
        ("wr_return_ship_cost", DEC), ("wr_refunded_cash", DEC),
        ("wr_reversed_charge", DEC), ("wr_account_credit", DEC),
        ("wr_net_loss", DEC),
    ],
}

_DATE_LO = days_from_civil(1998, 1, 1)
_DATE_HI = days_from_civil(2003, 12, 31)
_N_DATES = _DATE_HI - _DATE_LO + 1  # 2191
_DATE_SK0 = 2450815  # spec-style julian base for d_date_sk

_CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
               "Men", "Music", "Shoes", "Sports", "Women"]
_CLASSES = [f"class{i:02d}" for i in range(1, 17)]
_COLORS = ["red", "blue", "green", "yellow", "black", "white", "purple",
           "orange", "brown", "pink", "cyan", "magenta", "ivory", "gold"]
_STATES = ["AL", "CA", "GA", "IL", "KS", "MI", "NY", "OH", "TX", "WA"]
_COUNTIES = [f"{s} County {i}" for s in _STATES[:5] for i in range(1, 6)]
_BUY_POTENTIAL = ["0-500", "501-1000", "1001-5000", "5001-10000", ">10000", "Unknown"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
              "Advanced Degree", "Unknown"]
_CREDIT = ["Low Risk", "Good", "High Risk", "Unknown"]
_DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday"]


def scale_factor(schema: str) -> float:
    if schema == "tiny":
        return 0.01
    if schema.startswith("sf"):
        return float(schema[2:])
    raise KeyError(f"unknown tpcds schema: {schema}")


def _counts(sf: float) -> dict[str, int]:
    """Row counts (spec-shaped scaling; dims have floors)."""

    def s(base: int, floor: int = 1) -> int:
        return max(floor, int(base * sf))

    return {
        "date_dim": _N_DATES,  # fixed span (spec: 73049 covering 1900-2100)
        "time_dim": 86400 if sf >= 1 else 8640,
        "item": s(18_000, 100),
        "customer": s(100_000, 1000),
        "customer_address": s(50_000, 500),
        "customer_demographics": 19_208 if sf >= 0.1 else 1920,
        "household_demographics": 7200 if sf >= 0.1 else 720,
        "income_band": 20,
        "store": s(12, 2),
        "warehouse": s(5, 1),
        "ship_mode": 20,
        "reason": s(35, 5),
        "promotion": s(300, 10),
        "web_site": s(30, 2),
        "web_page": s(60, 4),
        "call_center": s(6, 2),
        "catalog_page": s(11_718, 100),
        "store_sales": s(2_880_404, 5000),
        "catalog_sales": s(1_441_548, 2500),
        "web_sales": s(719_384, 1200),
        "inventory": s(11_745_000, 10_000),
    }


class TpcdsConnector(Connector):
    name = "tpcds"

    def __init__(self, split_rows: int = 1 << 20, cache_bytes: int = 2 << 30):
        self.split_rows = split_rows
        self._dict_cache: dict[tuple, Dictionary] = {}
        # generated splits are deterministic: a host cache keeps them (all
        # their columns) so repeated queries measure the engine, not the
        # generator; least recently read entries go first
        self._batch_cache: OrderedDict[tuple, dict[str, Column]] = OrderedDict()
        self._batch_cache_bytes = 0
        self._batch_cache_limit = cache_bytes
        # cross-process split cache (connectors/diskcache.py): generation
        # is deterministic per (schema, table, split), so a cold process
        # reads back an earlier run's bytes instead of regenerating
        self._disk_cache = DbgenDiskCache()
        # staged device columns (see device_slab)
        self._device_cols = DeviceColumnStore()

    def disk_cache_stats(self) -> dict:
        """Hits and misses of the disk cache of generated splits."""
        return self._disk_cache.stats()

    # --- metadata --------------------------------------------------------

    def list_schemas(self):
        return ["tiny", "sf1", "sf10", "sf100"]

    def list_tables(self, schema):
        return sorted(_SCHEMAS)

    def get_table(self, schema, table):
        cols = _SCHEMAS.get(table)
        if cols is None:
            return None
        return TableSchema(table, tuple(ColumnSchema(n, t) for n, t in cols))

    def estimate_rows(self, schema, table):
        sf = scale_factor(schema)
        c = _counts(sf)
        if table in ("store_returns", "catalog_returns", "web_returns"):
            base = {"store_returns": "store_sales",
                    "catalog_returns": "catalog_sales",
                    "web_returns": "web_sales"}[table]
            return c[base] // 10
        return c[table]

    def table_stats(self, schema, table):
        from trino_tpu_torch.connectors.api import ColumnStats, TableStats

        rows = float(self.estimate_rows(schema, table))
        cols: dict[str, ColumnStats] = {}
        key = _PRIMARY_SK.get(table)
        if key is not None:
            cols[key] = ColumnStats(rows, 0.0, 1, int(rows))
        return TableStats(row_count=rows, columns=cols)

    # --- splits ----------------------------------------------------------

    def get_splits(self, schema, table, target_splits, constraint=None):
        rows = self.estimate_rows(schema, table)
        n = max(1, min(target_splits, (rows + self.split_rows - 1) // self.split_rows))
        splits = [Split(table, i, n) for i in range(n)]
        return self.prune_splits(schema, table, splits, constraint)

    def split_stats(self, schema, table, split):
        key = _PRIMARY_SK.get(table)
        if key is None:
            return None
        rows = self.estimate_rows(schema, table)
        lo, hi = _range(rows, split.index, split.total)
        if hi <= lo:
            return {key: (None, None, False)}
        return {key: (lo + 1, hi, False)}

    # --- generation ------------------------------------------------------

    def read_split(self, schema, table, columns, split):
        """The split's ``columns``, from the host cache of generated
        splits. A generator makes every column of its table at once, so
        the cache keeps them all and a query reading another subset of
        the same split generates nothing."""
        key = (schema, table, split.index, split.total)
        cols = self._batch_cache.get(key)
        if cols is not None:
            self._batch_cache.move_to_end(key)
        else:
            # the disk holds every column of the split, as the host cache
            disk_key = ("tpcds",) + key
            names = [c for c, _ in _SCHEMAS[table]]
            hit = self._disk_cache.get(disk_key)
            if hit is not None:
                cols = dict(zip(names, hit.columns))
            else:
                gen = getattr(self, f"_gen_{table}")
                cols = {
                    name: _host_column(c)
                    for name, c in gen(scale_factor(schema), split.index, split.total).items()
                }
                self._disk_cache.put(disk_key, Batch([cols[c] for c in names], 0))
            nbytes = _nbytes(cols.values())
            if nbytes <= self._batch_cache_limit:
                while self._batch_cache_bytes + nbytes > self._batch_cache_limit:
                    _, old = self._batch_cache.popitem(last=False)
                    self._batch_cache_bytes -= _nbytes(old.values())
                self._batch_cache[key] = cols
                self._batch_cache_bytes += nbytes
        out = [cols[c] for c in columns]
        return Batch(out, out[0].data.shape[0] if out else 0)

    def device_slab(self, schema, table, columns, cap: int, max_bytes: int,
                    device):
        """Stage a generated table's columns onto ``device``, for the
        streamed scan (``exec/streaming.py``). Returns (slab_batch,
        num_rows), or None when the columns exceed ``max_bytes``.

        The rows are those of the splits a table scan reads
        (``LocalExecutor._scan_splits``: 64 targeted, before pruning), in
        split order, generated directly so staging never evicts the host
        split cache. Each column is staged once per device and kept
        (``DeviceColumnStore``)."""
        ts = self.get_table(schema, table)
        if ts is None:
            return None
        sf = scale_factor(schema)
        by_name = {c.name: c for c in ts.columns}

        def generate(missing):
            gen = getattr(self, f"_gen_{table}")
            parts = []
            for s in self.get_splits(schema, table, 64):
                cols = gen(sf, s.index, s.total)
                out = [_host_column(cols[c]) for c in missing]
                parts.append(Batch(out, out[0].data.shape[0]))
            return parts

        return self._device_cols.slab(
            schema, table, columns, [by_name[c].type for c in columns],
            self.estimate_rows(schema, table), cap, max_bytes, device, generate,
        )

    def _rng(self, table: str, index: int) -> np.random.Generator:
        return np.random.default_rng(_stable_seed("tpcds", table, index))

    def _dict(self, name: str, values: list[str]) -> Dictionary:
        # key on the VALUES, not just the name: distinct columns may reuse a
        # label and must not poison each other's cached dictionary
        key = (name, tuple(values))
        if key not in self._dict_cache:
            self._dict_cache[key] = Dictionary(values)
        return self._dict_cache[key]

    def _dcol(self, name: str, values: list[str], codes: np.ndarray) -> Column:
        return Column(T.VARCHAR, codes.astype(np.int32), None,
                      self._dict(name, values))

    def _ids(self, prefix: str, keys: np.ndarray, width: int = 16) -> Column:
        # unique id strings derived from keys; dictionary is per-split
        vals = [f"{prefix}{k:0{width}d}" for k in keys.tolist()]
        d, codes = Dictionary.from_strings(vals)
        return Column(T.VARCHAR, codes, None, d)

    # --- dimensions -------------------------------------------------------

    def _gen_date_dim(self, sf, index, total):
        n = _counts(sf)["date_dim"]
        lo, hi = _range(n, index, total)
        days = np.arange(lo, hi, dtype=np.int64)
        dates = (_DATE_LO + days).astype(np.int32)
        sk = _DATE_SK0 + days
        # civil fields via numpy datetime
        dt = dates.astype("datetime64[D]")
        Y = dt.astype("datetime64[Y]").astype(np.int64) + 1970
        month_idx = dt.astype("datetime64[M]").astype(np.int64)
        moy = month_idx % 12 + 1
        dom = (dt - dt.astype("datetime64[M]")).astype(np.int64) + 1
        dow = (days + (_DATE_LO + 4)) % 7  # 1970-01-01 was a Thursday
        weekend = np.isin(dow, [0, 6])
        return {
            "d_date_sk": Column(T.BIGINT, sk),
            "d_date_id": self._ids("D", sk),
            "d_date": Column(T.DATE, dates),
            "d_month_seq": Column(T.BIGINT, month_idx),
            "d_week_seq": Column(T.BIGINT, (_DATE_LO + days) // 7),
            "d_quarter_seq": Column(T.BIGINT, month_idx // 3),
            "d_year": Column(T.BIGINT, Y),
            "d_dow": Column(T.BIGINT, dow),
            "d_moy": Column(T.BIGINT, moy),
            "d_dom": Column(T.BIGINT, dom),
            "d_qoy": Column(T.BIGINT, (moy - 1) // 3 + 1),
            "d_fy_year": Column(T.BIGINT, Y),
            "d_day_name": self._dcol("d_day_name", _DAY_NAMES, dow),
            "d_holiday": self._dcol("yn", ["N", "Y"], (sk % 37 == 0).astype(np.int32)),
            "d_weekend": self._dcol("yn", ["N", "Y"], weekend.astype(np.int32)),
        }

    def _gen_time_dim(self, sf, index, total):
        n = _counts(sf)["time_dim"]
        lo, hi = _range(n, index, total)
        t = np.arange(lo, hi, dtype=np.int64) * (86400 // n)
        hour = t // 3600
        return {
            "t_time_sk": Column(T.BIGINT, np.arange(lo + 1, hi + 1, dtype=np.int64)),
            "t_time_id": self._ids("T", np.arange(lo + 1, hi + 1, dtype=np.int64)),
            "t_time": Column(T.BIGINT, t),
            "t_hour": Column(T.BIGINT, hour),
            "t_minute": Column(T.BIGINT, (t % 3600) // 60),
            "t_second": Column(T.BIGINT, t % 60),
            "t_am_pm": self._dcol("ampm", ["AM", "PM"], (hour >= 12).astype(np.int32)),
            "t_shift": self._dcol("shift", ["first", "second", "third"],
                                  (hour // 8).astype(np.int32) % 3),
        }

    def _gen_item(self, sf, index, total):
        n = _counts(sf)["item"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        rng = self._rng("item", index)
        m = hi - lo
        cat = (keys * 7) % len(_CATEGORIES)
        cls = (keys * 11) % len(_CLASSES)
        price = rng.integers(99, 30000, m)
        brand_id = (keys * 13) % 1000 + 1
        return {
            "i_item_sk": Column(T.BIGINT, keys),
            "i_item_id": self._ids("I", keys),
            "i_item_desc": self._dcol(
                "i_desc", [f"item description {i}" for i in range(256)],
                (keys % 256).astype(np.int32)),
            "i_current_price": Column(DEC, price),
            "i_wholesale_cost": Column(DEC, (price * 6) // 10),
            "i_brand_id": Column(T.BIGINT, brand_id),
            "i_brand": self._dcol(
                "i_brand", [f"Brand#{i}" for i in range(1, 101)],
                (brand_id % 100).astype(np.int32)),
            "i_class_id": Column(T.BIGINT, cls + 1),
            "i_class": self._dcol("i_class", _CLASSES, cls),
            "i_category_id": Column(T.BIGINT, cat + 1),
            "i_category": self._dcol("i_cat", _CATEGORIES, cat),
            "i_manufact_id": Column(T.BIGINT, (keys * 17) % 1000 + 1),
            "i_manufact": self._dcol(
                "i_manu", [f"manufact{i}" for i in range(100)],
                ((keys * 17) % 100).astype(np.int32)),
            "i_size": self._dcol(
                "i_size", ["small", "medium", "large", "extra large", "N/A"],
                (keys % 5).astype(np.int32)),
            "i_color": self._dcol("i_color", _COLORS,
                                  ((keys * 19) % len(_COLORS)).astype(np.int32)),
            "i_units": self._dcol(
                "i_units", ["Each", "Dozen", "Case", "Pallet"],
                (keys % 4).astype(np.int32)),
            "i_product_name": self._ids("P", keys, 12),
        }

    def _gen_customer(self, sf, index, total):
        c = _counts(sf)
        n = c["customer"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        rng = self._rng("customer", index)
        m = hi - lo
        first_sale = _DATE_SK0 + rng.integers(0, _N_DATES, m)
        return {
            "c_customer_sk": Column(T.BIGINT, keys),
            "c_customer_id": self._ids("C", keys),
            "c_current_cdemo_sk": Column(
                T.BIGINT, rng.integers(1, c["customer_demographics"] + 1, m)),
            "c_current_hdemo_sk": Column(
                T.BIGINT, rng.integers(1, c["household_demographics"] + 1, m)),
            "c_current_addr_sk": Column(
                T.BIGINT, rng.integers(1, c["customer_address"] + 1, m)),
            "c_first_shipto_date_sk": Column(T.BIGINT, first_sale + 30),
            "c_first_sales_date_sk": Column(T.BIGINT, first_sale),
            "c_first_name": self._dcol(
                "fname", [f"First{i}" for i in range(512)],
                (keys % 512).astype(np.int32)),
            "c_last_name": self._dcol(
                "lname", [f"Last{i}" for i in range(1024)],
                ((keys * 3) % 1024).astype(np.int32)),
            "c_birth_year": Column(T.BIGINT, 1930 + (keys % 63)),
            "c_birth_country": self._dcol(
                "country", [f"COUNTRY_{i}" for i in range(50)],
                ((keys * 7) % 50).astype(np.int32)),
            "c_email_address": self._ids("E", keys, 10),
        }

    def _gen_customer_address(self, sf, index, total):
        n = _counts(sf)["customer_address"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        rng = self._rng("customer_address", index)
        m = hi - lo
        state = (keys * 3) % len(_STATES)
        return {
            "ca_address_sk": Column(T.BIGINT, keys),
            "ca_address_id": self._ids("A", keys),
            "ca_street_number": self._dcol(
                "st_no", [str(i) for i in range(1, 1001)],
                (keys % 1000).astype(np.int32)),
            "ca_street_name": self._dcol(
                "st_nm", [f"Street {i}" for i in range(256)],
                ((keys * 5) % 256).astype(np.int32)),
            "ca_city": self._dcol(
                "city", [f"City{i}" for i in range(128)],
                ((keys * 11) % 128).astype(np.int32)),
            "ca_county": self._dcol("county", _COUNTIES,
                                    ((keys * 13) % len(_COUNTIES)).astype(np.int32)),
            "ca_state": self._dcol("state", _STATES, state),
            "ca_zip": self._dcol(
                "zip", [f"{i:05d}" for i in range(10000, 10000 + 512)],
                ((keys * 17) % 512).astype(np.int32)),
            "ca_country": self._dcol("us", ["United States"],
                                     np.zeros(m, dtype=np.int32)),
            "ca_gmt_offset": Column(DEC, -500 - 100 * (state % 4)),
            "ca_location_type": self._dcol(
                "loctype", ["apartment", "condo", "single family"],
                (keys % 3).astype(np.int32)),
        }

    def _gen_customer_demographics(self, sf, index, total):
        n = _counts(sf)["customer_demographics"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        return {
            "cd_demo_sk": Column(T.BIGINT, keys),
            "cd_gender": self._dcol("gender", ["M", "F"], (keys % 2).astype(np.int32)),
            "cd_marital_status": self._dcol(
                "marital", ["M", "S", "D", "W", "U"], (keys % 5).astype(np.int32)),
            "cd_education_status": self._dcol(
                "edu", _EDUCATION, (keys % len(_EDUCATION)).astype(np.int32)),
            "cd_purchase_estimate": Column(T.BIGINT, (keys % 20) * 500 + 500),
            "cd_credit_rating": self._dcol(
                "credit", _CREDIT, (keys % len(_CREDIT)).astype(np.int32)),
            "cd_dep_count": Column(T.BIGINT, keys % 7),
        }

    def _gen_household_demographics(self, sf, index, total):
        n = _counts(sf)["household_demographics"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        return {
            "hd_demo_sk": Column(T.BIGINT, keys),
            "hd_income_band_sk": Column(T.BIGINT, keys % 20 + 1),
            "hd_buy_potential": self._dcol(
                "buypot", _BUY_POTENTIAL,
                (keys % len(_BUY_POTENTIAL)).astype(np.int32)),
            "hd_dep_count": Column(T.BIGINT, keys % 10),
            "hd_vehicle_count": Column(T.BIGINT, keys % 5),
        }

    def _gen_income_band(self, sf, index, total):
        lo, hi = _range(20, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        return {
            "ib_income_band_sk": Column(T.BIGINT, keys),
            "ib_lower_bound": Column(T.BIGINT, (keys - 1) * 10000),
            "ib_upper_bound": Column(T.BIGINT, keys * 10000),
        }

    def _gen_store(self, sf, index, total):
        n = _counts(sf)["store"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        rng = self._rng("store", index)
        m = hi - lo
        return {
            "s_store_sk": Column(T.BIGINT, keys),
            "s_store_id": self._ids("S", keys, 8),
            "s_store_name": self._dcol(
                "sname", ["ought", "able", "pri", "ese", "anti",
                          "cally", "ation", "eing", "bar"],
                (keys % 9).astype(np.int32)),
            "s_number_employees": Column(T.BIGINT, rng.integers(200, 300, m)),
            "s_floor_space": Column(T.BIGINT, rng.integers(5_000_000, 10_000_000, m)),
            "s_hours": self._dcol("hours", ["8AM-8AM", "8AM-4PM", "8AM-12AM"],
                                  (keys % 3).astype(np.int32)),
            "s_manager": self._dcol("mgr", [f"Manager {i}" for i in range(64)],
                                    (keys % 64).astype(np.int32)),
            "s_market_id": Column(T.BIGINT, keys % 10 + 1),
            "s_city": self._dcol("s_city", [f"City{i}" for i in range(128)],
                                 ((keys * 11) % 128).astype(np.int32)),
            "s_county": self._dcol("county", _COUNTIES,
                                   ((keys * 13) % len(_COUNTIES)).astype(np.int32)),
            "s_state": self._dcol("state", _STATES,
                                  ((keys * 3) % len(_STATES)).astype(np.int32)),
            "s_zip": self._dcol(
                "zip", [f"{i:05d}" for i in range(10000, 10000 + 512)],
                ((keys * 17) % 512).astype(np.int32)),
        }

    def _gen_warehouse(self, sf, index, total):
        n = _counts(sf)["warehouse"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        rng = self._rng("warehouse", index)
        return {
            "w_warehouse_sk": Column(T.BIGINT, keys),
            "w_warehouse_id": self._ids("W", keys, 8),
            "w_warehouse_name": self._dcol(
                "wname", [f"Warehouse {i}" for i in range(32)],
                (keys % 32).astype(np.int32)),
            "w_warehouse_sq_ft": Column(T.BIGINT, rng.integers(50_000, 1_000_000, hi - lo)),
            "w_city": self._dcol("s_city", [f"City{i}" for i in range(128)],
                                 ((keys * 11) % 128).astype(np.int32)),
            "w_state": self._dcol("state", _STATES,
                                  ((keys * 3) % len(_STATES)).astype(np.int32)),
            "w_country": self._dcol("us", ["United States"],
                                    np.zeros(hi - lo, dtype=np.int32)),
        }

    def _gen_ship_mode(self, sf, index, total):
        lo, hi = _range(20, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        return {
            "sm_ship_mode_sk": Column(T.BIGINT, keys),
            "sm_ship_mode_id": self._ids("SM", keys, 6),
            "sm_type": self._dcol(
                "smtype", ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY"],
                ((keys - 1) % 5).astype(np.int32)),
            "sm_code": self._dcol("smcode", ["AIR", "SURFACE", "SEA"],
                                  (keys % 3).astype(np.int32)),
            "sm_carrier": self._dcol(
                "smcarrier", [f"Carrier{i}" for i in range(20)],
                ((keys - 1) % 20).astype(np.int32)),
        }

    def _gen_reason(self, sf, index, total):
        n = _counts(sf)["reason"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        return {
            "r_reason_sk": Column(T.BIGINT, keys),
            "r_reason_id": self._ids("R", keys, 6),
            "r_reason_desc": self._dcol(
                "rdesc", [f"reason {i}" for i in range(64)],
                (keys % 64).astype(np.int32)),
        }

    def _gen_promotion(self, sf, index, total):
        c = _counts(sf)
        n = c["promotion"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        rng = self._rng("promotion", index)
        m = hi - lo
        start = _DATE_SK0 + rng.integers(0, _N_DATES - 60, m)
        return {
            "p_promo_sk": Column(T.BIGINT, keys),
            "p_promo_id": self._ids("PR", keys, 8),
            "p_start_date_sk": Column(T.BIGINT, start),
            "p_end_date_sk": Column(T.BIGINT, start + rng.integers(10, 60, m)),
            "p_item_sk": Column(T.BIGINT, rng.integers(1, c["item"] + 1, m)),
            "p_cost": Column(DEC, rng.integers(10000, 100000, m)),
            "p_channel_dmail": self._dcol("yn", ["N", "Y"], (keys % 2).astype(np.int32)),
            "p_channel_email": self._dcol("yn", ["N", "Y"], ((keys // 2) % 2).astype(np.int32)),
            "p_channel_tv": self._dcol("yn", ["N", "Y"], ((keys // 4) % 2).astype(np.int32)),
            "p_promo_name": self._dcol(
                "pname", [f"promo{i}" for i in range(64)],
                (keys % 64).astype(np.int32)),
        }

    def _gen_web_site(self, sf, index, total):
        n = _counts(sf)["web_site"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        return {
            "web_site_sk": Column(T.BIGINT, keys),
            "web_site_id": self._ids("WS", keys, 8),
            "web_name": self._dcol("wname", [f"site_{i}" for i in range(32)],
                                   (keys % 32).astype(np.int32)),
            "web_manager": self._dcol("mgr", [f"Manager {i}" for i in range(64)],
                                      ((keys * 3) % 64).astype(np.int32)),
            "web_company_name": self._dcol(
                "wcomp", ["pri", "able", "ought", "ese", "anti", "cally"],
                (keys % 6).astype(np.int32)),
            "web_state": self._dcol("state", _STATES,
                                    ((keys * 3) % len(_STATES)).astype(np.int32)),
        }

    def _gen_web_page(self, sf, index, total):
        n = _counts(sf)["web_page"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        rng = self._rng("web_page", index)
        m = hi - lo
        return {
            "wp_web_page_sk": Column(T.BIGINT, keys),
            "wp_web_page_id": self._ids("WP", keys, 8),
            "wp_url": self._dcol("wpurl", ["http://www.foo.com"],
                                 np.zeros(m, dtype=np.int32)),
            "wp_type": self._dcol(
                "wptype", ["ad", "dynamic", "feedback", "general", "order",
                           "protected", "welcome"],
                (keys % 7).astype(np.int32)),
            "wp_char_count": Column(T.BIGINT, rng.integers(100, 8000, m)),
            "wp_link_count": Column(T.BIGINT, rng.integers(2, 25, m)),
        }

    def _gen_call_center(self, sf, index, total):
        n = _counts(sf)["call_center"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        rng = self._rng("call_center", index)
        return {
            "cc_call_center_sk": Column(T.BIGINT, keys),
            "cc_call_center_id": self._ids("CC", keys, 8),
            "cc_name": self._dcol(
                "ccname", [f"call center {i}" for i in range(16)],
                (keys % 16).astype(np.int32)),
            "cc_class": self._dcol("ccclass", ["small", "medium", "large"],
                                   (keys % 3).astype(np.int32)),
            "cc_employees": Column(T.BIGINT, rng.integers(50, 500, hi - lo)),
            "cc_manager": self._dcol("mgr", [f"Manager {i}" for i in range(64)],
                                     ((keys * 5) % 64).astype(np.int32)),
            "cc_county": self._dcol("county", _COUNTIES,
                                    ((keys * 13) % len(_COUNTIES)).astype(np.int32)),
            "cc_state": self._dcol("state", _STATES,
                                   ((keys * 3) % len(_STATES)).astype(np.int32)),
        }

    def _gen_catalog_page(self, sf, index, total):
        n = _counts(sf)["catalog_page"]
        lo, hi = _range(n, index, total)
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        return {
            "cp_catalog_page_sk": Column(T.BIGINT, keys),
            "cp_catalog_page_id": self._ids("CP", keys, 8),
            "cp_department": self._dcol("dept", ["DEPARTMENT"],
                                        np.zeros(hi - lo, dtype=np.int32)),
            "cp_catalog_number": Column(T.BIGINT, keys // 100 + 1),
            "cp_catalog_page_number": Column(T.BIGINT, keys % 100 + 1),
            "cp_type": self._dcol("cptype", ["annual", "quarterly", "bi-annual"],
                                  (keys % 3).astype(np.int32)),
        }

    def _gen_inventory(self, sf, index, total):
        c = _counts(sf)
        n = c["inventory"]
        lo, hi = _range(n, index, total)
        idx = np.arange(lo, hi, dtype=np.int64)
        n_items = c["item"]
        n_wh = c["warehouse"]
        rng = self._rng("inventory", index)
        # weekly snapshots: week index wraps within the date_dim span so
        # inv_date_sk always joins date_dim
        week = idx // max(1, n_items * n_wh)
        return {
            "inv_date_sk": Column(T.BIGINT, _DATE_SK0 + (week * 7) % _N_DATES),
            "inv_item_sk": Column(T.BIGINT, (idx // n_wh) % n_items + 1),
            "inv_warehouse_sk": Column(T.BIGINT, idx % n_wh + 1),
            "inv_quantity_on_hand": Column(T.BIGINT, rng.integers(0, 1000, hi - lo)),
        }

    # --- facts ------------------------------------------------------------

    def _sales_common(self, table, sf, index, total):
        """Shared generator for the three sales channels."""
        c = _counts(sf)
        n = c[table]
        lo, hi = _range(n, index, total)
        m = hi - lo
        rng = self._rng(table, index)
        rows = np.arange(lo, hi, dtype=np.int64)
        # ~12 lines per order/ticket
        order = rows // 12 + 1
        item = _keyhash(rows, 1) % c["item"] + 1
        sold_date = _DATE_SK0 + (_keyhash(order, 2) % _N_DATES)
        qty = _keyhash(rows, 3) % 100 + 1
        wholesale = _keyhash(rows, 4) % 9900 + 100       # 1.00 - 99.99
        list_price = wholesale + wholesale * (_keyhash(rows, 5) % 100) // 100
        sales_price = list_price - list_price * (_keyhash(rows, 6) % 50) // 100
        ext_sales = sales_price * qty
        ext_wholesale = wholesale * qty
        ext_list = list_price * qty
        ext_discount = (list_price - sales_price) * qty
        tax = ext_sales * 8 // 100
        coupon = np.where(_keyhash(rows, 7) % 10 == 0, ext_sales // 10, 0)
        net_paid = ext_sales - coupon
        net_profit = net_paid - ext_wholesale
        return {
            "c": c, "m": m, "rng": rng, "rows": rows, "order": order,
            "item": item, "sold_date": sold_date, "qty": qty,
            "wholesale": wholesale, "list_price": list_price,
            "sales_price": sales_price, "ext_sales": ext_sales,
            "ext_wholesale": ext_wholesale, "ext_list": ext_list,
            "ext_discount": ext_discount, "tax": tax, "coupon": coupon,
            "net_paid": net_paid, "net_profit": net_profit,
        }

    def _gen_store_sales(self, sf, index, total):
        g = self._sales_common("store_sales", sf, index, total)
        c, rows = g["c"], g["rows"]
        return {
            "ss_sold_date_sk": Column(T.BIGINT, g["sold_date"]),
            "ss_sold_time_sk": Column(T.BIGINT, _keyhash(rows, 8) % c["time_dim"] + 1),
            "ss_item_sk": Column(T.BIGINT, g["item"]),
            "ss_customer_sk": Column(T.BIGINT, _keyhash(g["order"], 9) % c["customer"] + 1),
            "ss_cdemo_sk": Column(T.BIGINT, _keyhash(g["order"], 10) % c["customer_demographics"] + 1),
            "ss_hdemo_sk": Column(T.BIGINT, _keyhash(g["order"], 11) % c["household_demographics"] + 1),
            "ss_addr_sk": Column(T.BIGINT, _keyhash(g["order"], 12) % c["customer_address"] + 1),
            "ss_store_sk": Column(T.BIGINT, _keyhash(g["order"], 13) % c["store"] + 1),
            "ss_promo_sk": Column(T.BIGINT, _keyhash(rows, 14) % c["promotion"] + 1),
            "ss_ticket_number": Column(T.BIGINT, g["order"]),
            "ss_quantity": Column(T.BIGINT, g["qty"]),
            "ss_wholesale_cost": Column(DEC, g["wholesale"]),
            "ss_list_price": Column(DEC, g["list_price"]),
            "ss_sales_price": Column(DEC, g["sales_price"]),
            "ss_ext_discount_amt": Column(DEC, g["ext_discount"]),
            "ss_ext_sales_price": Column(DEC, g["ext_sales"]),
            "ss_ext_wholesale_cost": Column(DEC, g["ext_wholesale"]),
            "ss_ext_list_price": Column(DEC, g["ext_list"]),
            "ss_ext_tax": Column(DEC, g["tax"]),
            "ss_coupon_amt": Column(DEC, g["coupon"]),
            "ss_net_paid": Column(DEC, g["net_paid"]),
            "ss_net_paid_inc_tax": Column(DEC, g["net_paid"] + g["tax"]),
            "ss_net_profit": Column(DEC, g["net_profit"]),
        }

    def _gen_catalog_sales(self, sf, index, total):
        g = self._sales_common("catalog_sales", sf, index, total)
        c, rows = g["c"], g["rows"]
        ship_cost = g["ext_sales"] // 20
        return {
            "cs_sold_date_sk": Column(T.BIGINT, g["sold_date"]),
            "cs_sold_time_sk": Column(T.BIGINT, _keyhash(rows, 8) % c["time_dim"] + 1),
            "cs_ship_date_sk": Column(T.BIGINT, g["sold_date"] + _keyhash(rows, 20) % 30 + 2),
            "cs_bill_customer_sk": Column(T.BIGINT, _keyhash(g["order"], 9) % c["customer"] + 1),
            "cs_bill_cdemo_sk": Column(T.BIGINT, _keyhash(g["order"], 10) % c["customer_demographics"] + 1),
            "cs_bill_hdemo_sk": Column(T.BIGINT, _keyhash(g["order"], 11) % c["household_demographics"] + 1),
            "cs_bill_addr_sk": Column(T.BIGINT, _keyhash(g["order"], 12) % c["customer_address"] + 1),
            "cs_ship_customer_sk": Column(T.BIGINT, _keyhash(g["order"], 15) % c["customer"] + 1),
            "cs_ship_addr_sk": Column(T.BIGINT, _keyhash(g["order"], 16) % c["customer_address"] + 1),
            "cs_call_center_sk": Column(T.BIGINT, _keyhash(g["order"], 17) % c["call_center"] + 1),
            "cs_catalog_page_sk": Column(T.BIGINT, _keyhash(rows, 18) % c["catalog_page"] + 1),
            "cs_ship_mode_sk": Column(T.BIGINT, _keyhash(g["order"], 19) % 20 + 1),
            "cs_warehouse_sk": Column(T.BIGINT, _keyhash(rows, 21) % c["warehouse"] + 1),
            "cs_item_sk": Column(T.BIGINT, g["item"]),
            "cs_promo_sk": Column(T.BIGINT, _keyhash(rows, 14) % c["promotion"] + 1),
            "cs_order_number": Column(T.BIGINT, g["order"]),
            "cs_quantity": Column(T.BIGINT, g["qty"]),
            "cs_wholesale_cost": Column(DEC, g["wholesale"]),
            "cs_list_price": Column(DEC, g["list_price"]),
            "cs_sales_price": Column(DEC, g["sales_price"]),
            "cs_ext_discount_amt": Column(DEC, g["ext_discount"]),
            "cs_ext_sales_price": Column(DEC, g["ext_sales"]),
            "cs_ext_wholesale_cost": Column(DEC, g["ext_wholesale"]),
            "cs_ext_list_price": Column(DEC, g["ext_list"]),
            "cs_ext_tax": Column(DEC, g["tax"]),
            "cs_coupon_amt": Column(DEC, g["coupon"]),
            "cs_ext_ship_cost": Column(DEC, ship_cost),
            "cs_net_paid": Column(DEC, g["net_paid"]),
            "cs_net_paid_inc_tax": Column(DEC, g["net_paid"] + g["tax"]),
            "cs_net_paid_inc_ship": Column(DEC, g["net_paid"] + ship_cost),
            "cs_net_paid_inc_ship_tax": Column(DEC, g["net_paid"] + ship_cost + g["tax"]),
            "cs_net_profit": Column(DEC, g["net_profit"]),
        }

    def _gen_web_sales(self, sf, index, total):
        g = self._sales_common("web_sales", sf, index, total)
        c, rows = g["c"], g["rows"]
        ship_cost = g["ext_sales"] // 20
        return {
            "ws_sold_date_sk": Column(T.BIGINT, g["sold_date"]),
            "ws_sold_time_sk": Column(T.BIGINT, _keyhash(rows, 8) % c["time_dim"] + 1),
            "ws_ship_date_sk": Column(T.BIGINT, g["sold_date"] + _keyhash(g["order"], 20) % 60 + 1),
            "ws_item_sk": Column(T.BIGINT, g["item"]),
            "ws_bill_customer_sk": Column(T.BIGINT, _keyhash(g["order"], 9) % c["customer"] + 1),
            "ws_bill_cdemo_sk": Column(T.BIGINT, _keyhash(g["order"], 10) % c["customer_demographics"] + 1),
            "ws_bill_hdemo_sk": Column(T.BIGINT, _keyhash(g["order"], 11) % c["household_demographics"] + 1),
            "ws_bill_addr_sk": Column(T.BIGINT, _keyhash(g["order"], 12) % c["customer_address"] + 1),
            "ws_ship_customer_sk": Column(T.BIGINT, _keyhash(g["order"], 15) % c["customer"] + 1),
            "ws_ship_addr_sk": Column(T.BIGINT, _keyhash(g["order"], 16) % c["customer_address"] + 1),
            "ws_web_page_sk": Column(T.BIGINT, _keyhash(rows, 17) % c["web_page"] + 1),
            "ws_web_site_sk": Column(T.BIGINT, _keyhash(g["order"], 18) % c["web_site"] + 1),
            "ws_ship_mode_sk": Column(T.BIGINT, _keyhash(g["order"], 19) % 20 + 1),
            "ws_warehouse_sk": Column(T.BIGINT, _keyhash(g["order"], 21) % c["warehouse"] + 1),
            "ws_promo_sk": Column(T.BIGINT, _keyhash(rows, 14) % c["promotion"] + 1),
            "ws_order_number": Column(T.BIGINT, g["order"]),
            "ws_quantity": Column(T.BIGINT, g["qty"]),
            "ws_wholesale_cost": Column(DEC, g["wholesale"]),
            "ws_list_price": Column(DEC, g["list_price"]),
            "ws_sales_price": Column(DEC, g["sales_price"]),
            "ws_ext_discount_amt": Column(DEC, g["ext_discount"]),
            "ws_ext_sales_price": Column(DEC, g["ext_sales"]),
            "ws_ext_wholesale_cost": Column(DEC, g["ext_wholesale"]),
            "ws_ext_list_price": Column(DEC, g["ext_list"]),
            "ws_ext_tax": Column(DEC, g["tax"]),
            "ws_coupon_amt": Column(DEC, g["coupon"]),
            "ws_ext_ship_cost": Column(DEC, ship_cost),
            "ws_net_paid": Column(DEC, g["net_paid"]),
            "ws_net_paid_inc_tax": Column(DEC, g["net_paid"] + g["tax"]),
            "ws_net_paid_inc_ship": Column(DEC, g["net_paid"] + ship_cost),
            "ws_net_paid_inc_ship_tax": Column(DEC, g["net_paid"] + ship_cost + g["tax"]),
            "ws_net_profit": Column(DEC, g["net_profit"]),
        }

    # --- returns: ~10% of the matching sales split, same keys -------------

    def _returns_base(self, sales_table, sf, index, total):
        sales = getattr(self, f"_gen_{sales_table}")(sf, index, total)
        prefix = {"store_sales": "ss", "catalog_sales": "cs", "web_sales": "ws"}[
            sales_table
        ]
        order_col = {"store_sales": "ss_ticket_number",
                     "catalog_sales": "cs_order_number",
                     "web_sales": "ws_order_number"}[sales_table]
        item = np.asarray(sales[f"{prefix}_item_sk"].data)
        order = np.asarray(sales[order_col].data)
        rows = np.arange(len(item), dtype=np.int64)
        mask = _keyhash(order * 131 + item, 40) % 10 == 0
        sel = rows[mask]
        return sales, prefix, item[mask], order[mask], sel

    def _gen_store_returns(self, sf, index, total):
        c = _counts(sf)
        sales, _, item, order, sel = self._returns_base("store_sales", sf, index, total)
        m = len(sel)
        amt = np.asarray(sales["ss_sales_price"].data)[sel]
        qty = np.maximum(1, np.asarray(sales["ss_quantity"].data)[sel] // 2)
        ramt = amt * qty
        tax = ramt * 8 // 100
        sold = np.asarray(sales["ss_sold_date_sk"].data)[sel]
        return {
            "sr_returned_date_sk": Column(T.BIGINT, sold + _keyhash(order, 41) % 60 + 1),
            "sr_return_time_sk": Column(T.BIGINT, _keyhash(order, 42) % c["time_dim"] + 1),
            "sr_item_sk": Column(T.BIGINT, item),
            "sr_customer_sk": Column(T.BIGINT, np.asarray(sales["ss_customer_sk"].data)[sel]),
            "sr_cdemo_sk": Column(T.BIGINT, np.asarray(sales["ss_cdemo_sk"].data)[sel]),
            "sr_hdemo_sk": Column(T.BIGINT, np.asarray(sales["ss_hdemo_sk"].data)[sel]),
            "sr_addr_sk": Column(T.BIGINT, np.asarray(sales["ss_addr_sk"].data)[sel]),
            "sr_store_sk": Column(T.BIGINT, np.asarray(sales["ss_store_sk"].data)[sel]),
            "sr_reason_sk": Column(T.BIGINT, _keyhash(order, 43) % c["reason"] + 1),
            "sr_ticket_number": Column(T.BIGINT, order),
            "sr_return_quantity": Column(T.BIGINT, qty),
            "sr_return_amt": Column(DEC, ramt),
            "sr_return_tax": Column(DEC, tax),
            "sr_return_amt_inc_tax": Column(DEC, ramt + tax),
            "sr_fee": Column(DEC, np.full(m, 500, dtype=np.int64)),
            "sr_return_ship_cost": Column(DEC, ramt // 20),
            "sr_refunded_cash": Column(DEC, ramt // 2),
            "sr_reversed_charge": Column(DEC, ramt // 4),
            "sr_store_credit": Column(DEC, ramt - ramt // 2 - ramt // 4),
            "sr_net_loss": Column(DEC, ramt // 10 + 500),
        }

    def _gen_catalog_returns(self, sf, index, total):
        c = _counts(sf)
        sales, _, item, order, sel = self._returns_base("catalog_sales", sf, index, total)
        m = len(sel)
        amt = np.asarray(sales["cs_sales_price"].data)[sel]
        qty = np.maximum(1, np.asarray(sales["cs_quantity"].data)[sel] // 2)
        ramt = amt * qty
        tax = ramt * 8 // 100
        sold = np.asarray(sales["cs_sold_date_sk"].data)[sel]
        return {
            "cr_returned_date_sk": Column(T.BIGINT, sold + _keyhash(order, 41) % 60 + 1),
            "cr_returned_time_sk": Column(T.BIGINT, _keyhash(order, 42) % c["time_dim"] + 1),
            "cr_item_sk": Column(T.BIGINT, item),
            "cr_refunded_customer_sk": Column(T.BIGINT, np.asarray(sales["cs_bill_customer_sk"].data)[sel]),
            "cr_refunded_addr_sk": Column(T.BIGINT, np.asarray(sales["cs_bill_addr_sk"].data)[sel]),
            "cr_returning_customer_sk": Column(T.BIGINT, np.asarray(sales["cs_ship_customer_sk"].data)[sel]),
            "cr_call_center_sk": Column(T.BIGINT, np.asarray(sales["cs_call_center_sk"].data)[sel]),
            "cr_catalog_page_sk": Column(T.BIGINT, np.asarray(sales["cs_catalog_page_sk"].data)[sel]),
            "cr_ship_mode_sk": Column(T.BIGINT, np.asarray(sales["cs_ship_mode_sk"].data)[sel]),
            "cr_warehouse_sk": Column(T.BIGINT, np.asarray(sales["cs_warehouse_sk"].data)[sel]),
            "cr_reason_sk": Column(T.BIGINT, _keyhash(order, 43) % c["reason"] + 1),
            "cr_order_number": Column(T.BIGINT, order),
            "cr_return_quantity": Column(T.BIGINT, qty),
            "cr_return_amount": Column(DEC, ramt),
            "cr_return_tax": Column(DEC, tax),
            "cr_return_amt_inc_tax": Column(DEC, ramt + tax),
            "cr_fee": Column(DEC, np.full(m, 500, dtype=np.int64)),
            "cr_return_ship_cost": Column(DEC, ramt // 20),
            "cr_refunded_cash": Column(DEC, ramt // 2),
            "cr_reversed_charge": Column(DEC, ramt // 4),
            "cr_store_credit": Column(DEC, ramt - ramt // 2 - ramt // 4),
            "cr_net_loss": Column(DEC, ramt // 10 + 500),
        }

    def _gen_web_returns(self, sf, index, total):
        c = _counts(sf)
        sales, _, item, order, sel = self._returns_base("web_sales", sf, index, total)
        m = len(sel)
        amt = np.asarray(sales["ws_sales_price"].data)[sel]
        qty = np.maximum(1, np.asarray(sales["ws_quantity"].data)[sel] // 2)
        ramt = amt * qty
        tax = ramt * 8 // 100
        sold = np.asarray(sales["ws_sold_date_sk"].data)[sel]
        return {
            "wr_returned_date_sk": Column(T.BIGINT, sold + _keyhash(order, 41) % 60 + 1),
            "wr_returned_time_sk": Column(T.BIGINT, _keyhash(order, 42) % c["time_dim"] + 1),
            "wr_item_sk": Column(T.BIGINT, item),
            "wr_refunded_customer_sk": Column(T.BIGINT, np.asarray(sales["ws_bill_customer_sk"].data)[sel]),
            "wr_refunded_addr_sk": Column(T.BIGINT, np.asarray(sales["ws_bill_addr_sk"].data)[sel]),
            "wr_returning_customer_sk": Column(T.BIGINT, np.asarray(sales["ws_ship_customer_sk"].data)[sel]),
            "wr_web_page_sk": Column(T.BIGINT, np.asarray(sales["ws_web_page_sk"].data)[sel]),
            "wr_reason_sk": Column(T.BIGINT, _keyhash(order, 43) % c["reason"] + 1),
            "wr_order_number": Column(T.BIGINT, order),
            "wr_return_quantity": Column(T.BIGINT, qty),
            "wr_return_amt": Column(DEC, ramt),
            "wr_return_tax": Column(DEC, tax),
            "wr_return_amt_inc_tax": Column(DEC, ramt + tax),
            "wr_fee": Column(DEC, np.full(m, 500, dtype=np.int64)),
            "wr_return_ship_cost": Column(DEC, ramt // 20),
            "wr_refunded_cash": Column(DEC, ramt // 2),
            "wr_reversed_charge": Column(DEC, ramt // 4),
            "wr_account_credit": Column(DEC, ramt - ramt // 2 - ramt // 4),
            "wr_net_loss": Column(DEC, ramt // 10 + 500),
        }


_PRIMARY_SK = {
    "item": "i_item_sk", "customer": "c_customer_sk",
    "customer_address": "ca_address_sk",
    "customer_demographics": "cd_demo_sk",
    "household_demographics": "hd_demo_sk", "income_band": "ib_income_band_sk",
    "store": "s_store_sk", "warehouse": "w_warehouse_sk",
    "ship_mode": "sm_ship_mode_sk", "reason": "r_reason_sk",
    "promotion": "p_promo_sk", "web_site": "web_site_sk",
    "web_page": "wp_web_page_sk", "call_center": "cc_call_center_sk",
    "catalog_page": "cp_catalog_page_sk", "time_dim": "t_time_sk",
}


def _host_column(c: Column) -> Column:
    """A generated numpy column as a host column of CPU tensors in its
    type's storage dtype."""
    data = np.ascontiguousarray(np.asarray(c.data).astype(c.type.storage_dtype, copy=False))
    valid = None if c.valid is None else as_tensor(np.asarray(c.valid, dtype=np.bool_))
    return Column(c.type, as_tensor(data), valid, c.dictionary)


def _nbytes(columns) -> int:
    return sum(
        c.data.numel() * c.data.element_size()
        + (0 if c.valid is None else c.valid.numel())
        for c in columns
    )


def _range(total_rows: int, index: int, total: int) -> tuple[int, int]:
    per = (total_rows + total - 1) // total
    lo = index * per
    hi = min(total_rows, lo + per)
    return lo, hi


def _stable_seed(*parts) -> int:
    """Process-stable RNG seed (PYTHONHASHSEED-independent)."""
    import hashlib

    h = hashlib.sha256(":".join(map(str, parts)).encode()).digest()
    return int.from_bytes(h[:8], "little")


def _keyhash(keys: np.ndarray, stream: int) -> np.ndarray:
    """Deterministic keyed hash stream -> non-negative int64."""
    x = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(
        stream * 0xD1B54A32D192ED03 % (2**64)
    )
    x ^= x >> np.uint64(29)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(32)
    return (x >> np.uint64(1)).astype(np.int64)
