"""TPC-DS query corpus (spec text), parameterized by schema.

Reference: ``testing/trino-benchto-benchmarks/src/main/resources/benchmarks/
presto/tpcds.yaml``. The port's own copy of the reference's TPC-DS corpus:
the 64 queries of ``tests/test_tpcds_suite.py`` and
``tests/test_tpcds_oracle.py`` (the oracle file's text where a query is in
both, as the reference's fused test takes it), Q64 and Q95 among them as
in ``trino_tpu/benchmarks/tpcds.py``. Constants are adapted to the tiny
generator's domains where the test corpus notes it. Kept as data so that
scripts of the port such as ``chip_smoke.py`` run spec text without
importing the JAX package or the tests.

Rows are held against committed answers with the helpers of
``benchmarks/tpch.py`` (``canonical_rows``, ``order_positions``,
``first_mismatch``).
"""

import os

ANSWERS_TINY = os.path.join(os.path.dirname(__file__), "tpcds_tiny_answers.json")
ANSWERS_SF1 = os.path.join(os.path.dirname(__file__), "tpcds_sf1_answers.json")
# Q64 and Q95 only (BASELINE.json config 3)
ANSWERS_SF10 = os.path.join(os.path.dirname(__file__), "tpcds_sf10_answers.json")

# query text with ``{S}`` where the schema goes (e.g. tpcds.sf1)
_TEXTS = {
    1: """
with customer_total_return as (
  select sr_customer_sk as ctr_customer_sk, sr_store_sk as ctr_store_sk,
         sum(sr_return_amt) as ctr_total_return
  from {S}.store_returns, {S}.date_dim
  where sr_returned_date_sk = d_date_sk and d_year = 2000
  group by sr_customer_sk, sr_store_sk)
select c_customer_id
from customer_total_return ctr1, {S}.store, {S}.customer
where ctr1.ctr_total_return > (select avg(ctr_total_return) * 1.2
                               from customer_total_return ctr2
                               where ctr1.ctr_store_sk = ctr2.ctr_store_sk)
  and s_store_sk = ctr1.ctr_store_sk and s_state = 'NY'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id limit 100""",
    2: """
with wscs as (
  select ws_sold_date_sk sold_date_sk, ws_ext_sales_price sales_price
  from {S}.web_sales
  union all
  select cs_sold_date_sk sold_date_sk, cs_ext_sales_price sales_price
  from {S}.catalog_sales),
wswscs as (
  select d_week_seq,
    sum(case when d_day_name = 'Sunday' then sales_price else null end)
      sun_sales,
    sum(case when d_day_name = 'Monday' then sales_price else null end)
      mon_sales,
    sum(case when d_day_name = 'Tuesday' then sales_price else null end)
      tue_sales,
    sum(case when d_day_name = 'Wednesday' then sales_price else null end)
      wed_sales,
    sum(case when d_day_name = 'Thursday' then sales_price else null end)
      thu_sales,
    sum(case when d_day_name = 'Friday' then sales_price else null end)
      fri_sales,
    sum(case when d_day_name = 'Saturday' then sales_price else null end)
      sat_sales
  from wscs, {S}.date_dim
  where d_date_sk = sold_date_sk
  group by d_week_seq)
select d_week_seq1, round(sun_sales1 / sun_sales2, 2),
       round(mon_sales1 / mon_sales2, 2), round(tue_sales1 / tue_sales2, 2),
       round(wed_sales1 / wed_sales2, 2), round(thu_sales1 / thu_sales2, 2),
       round(fri_sales1 / fri_sales2, 2), round(sat_sales1 / sat_sales2, 2)
from (select wswscs.d_week_seq d_week_seq1, sun_sales sun_sales1,
             mon_sales mon_sales1, tue_sales tue_sales1,
             wed_sales wed_sales1, thu_sales thu_sales1,
             fri_sales fri_sales1, sat_sales sat_sales1
      from wswscs, {S}.date_dim
      where date_dim.d_week_seq = wswscs.d_week_seq and d_year = 2001) y,
     (select wswscs.d_week_seq d_week_seq2, sun_sales sun_sales2,
             mon_sales mon_sales2, tue_sales tue_sales2,
             wed_sales wed_sales2, thu_sales thu_sales2,
             fri_sales fri_sales2, sat_sales sat_sales2
      from wswscs, {S}.date_dim
      where date_dim.d_week_seq = wswscs.d_week_seq and d_year = 2002) z
where d_week_seq1 = d_week_seq2 - 53
order by d_week_seq1""",
    3: """
select d.d_year, i.i_brand_id, i.i_brand, sum(ss.ss_ext_sales_price) sum_agg
from {S}.date_dim d, {S}.store_sales ss, {S}.item i
where d.d_date_sk = ss.ss_sold_date_sk and ss.ss_item_sk = i.i_item_sk
  and i.i_manufact_id = 128 and d.d_moy = 11
group by d.d_year, i.i_brand, i.i_brand_id
order by d.d_year, sum_agg desc, i.i_brand_id limit 100""",
    6: """
select a.ca_state state, count(*) cnt
from {S}.customer_address a, {S}.customer c, {S}.store_sales s,
     {S}.date_dim d, {S}.item i
where a.ca_address_sk = c.c_current_addr_sk
  and c.c_customer_sk = s.ss_customer_sk
  and s.ss_sold_date_sk = d.d_date_sk and s.ss_item_sk = i.i_item_sk
  and d.d_month_seq = (select min(d_month_seq) from {S}.date_dim
                       where d_year = 2001 and d_moy = 1)
  and i.i_current_price > 1.2 * (select avg(j.i_current_price)
                                 from {S}.item j
                                 where j.i_category = i.i_category)
group by a.ca_state having count(*) >= 2
order by cnt, a.ca_state limit 100""",
    7: """
select i.i_item_id, avg(ss.ss_quantity) agg1, avg(ss.ss_list_price) agg2,
       avg(ss.ss_coupon_amt) agg3, avg(ss.ss_sales_price) agg4
from {S}.store_sales ss, {S}.customer_demographics cd, {S}.date_dim d,
     {S}.item i, {S}.promotion p
where ss.ss_sold_date_sk = d.d_date_sk and ss.ss_item_sk = i.i_item_sk
  and ss.ss_cdemo_sk = cd.cd_demo_sk and ss.ss_promo_sk = p.p_promo_sk
  and cd.cd_gender = 'M' and cd.cd_marital_status = 'S'
  and cd.cd_education_status = 'College'
  and (p.p_channel_email = 'N' or p.p_channel_tv = 'N') and d.d_year = 2000
group by i.i_item_id order by i.i_item_id limit 100""",
    9: """
select case when (select count(*) from {S}.store_sales
                  where ss_quantity between 1 and 20) > 15000
            then (select avg(ss_ext_discount_amt) from {S}.store_sales
                  where ss_quantity between 1 and 20)
            else (select avg(ss_net_paid) from {S}.store_sales
                  where ss_quantity between 1 and 20) end bucket1,
       case when (select count(*) from {S}.store_sales
                  where ss_quantity between 21 and 40) > 10000
            then (select avg(ss_ext_discount_amt) from {S}.store_sales
                  where ss_quantity between 21 and 40)
            else (select avg(ss_net_paid) from {S}.store_sales
                  where ss_quantity between 21 and 40) end bucket2,
       case when (select count(*) from {S}.store_sales
                  where ss_quantity between 41 and 60) > 5000
            then (select avg(ss_ext_discount_amt) from {S}.store_sales
                  where ss_quantity between 41 and 60)
            else (select avg(ss_net_paid) from {S}.store_sales
                  where ss_quantity between 41 and 60) end bucket3,
       case when (select count(*) from {S}.store_sales
                  where ss_quantity between 61 and 80) > 1000
            then (select avg(ss_ext_discount_amt) from {S}.store_sales
                  where ss_quantity between 61 and 80)
            else (select avg(ss_net_paid) from {S}.store_sales
                  where ss_quantity between 61 and 80) end bucket4,
       case when (select count(*) from {S}.store_sales
                  where ss_quantity between 81 and 100) > 500
            then (select avg(ss_ext_discount_amt) from {S}.store_sales
                  where ss_quantity between 81 and 100)
            else (select avg(ss_net_paid) from {S}.store_sales
                  where ss_quantity between 81 and 100) end bucket5
from {S}.reason where r_reason_sk = 1""",
    12: """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ws_ext_sales_price) as itemrevenue,
       sum(ws_ext_sales_price) * 100 / sum(sum(ws_ext_sales_price))
         over (partition by i_class) as revenueratio
from {S}.web_sales, {S}.item, {S}.date_dim
where ws_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and ws_sold_date_sk = d_date_sk
  and d_date between date '1999-02-22' and date '1999-03-24'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100""",
    13: """
select avg(ss_quantity), avg(ss_ext_sales_price),
       avg(ss_ext_wholesale_cost), sum(ss_ext_wholesale_cost)
from {S}.store_sales, {S}.store, {S}.customer_demographics,
     {S}.household_demographics, {S}.customer_address, {S}.date_dim
where s_store_sk = ss_store_sk and ss_sold_date_sk = d_date_sk
  and d_year = 2001
  and ((ss_hdemo_sk = hd_demo_sk and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = 'M' and cd_education_status = 'Advanced Degree'
        and ss_sales_price between 100.00 and 150.00 and hd_dep_count = 3)
    or (ss_hdemo_sk = hd_demo_sk and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = 'S' and cd_education_status = 'College'
        and ss_sales_price between 50.00 and 100.00 and hd_dep_count = 1)
    or (ss_hdemo_sk = hd_demo_sk and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = 'W' and cd_education_status = '2 yr Degree'
        and ss_sales_price between 150.00 and 200.00 and hd_dep_count = 1))
  and ((ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('TX', 'OH', 'TX') and ss_net_profit between 100 and 200)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('OR', 'NM', 'KY') and ss_net_profit between 150 and 300)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('VA', 'TX', 'MS') and ss_net_profit between 50 and 250))""",
    15: """
select ca_zip, sum(cs_sales_price)
from {S}.catalog_sales, {S}.customer, {S}.customer_address, {S}.date_dim
where cs_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and (substr(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405', '86475',
                                '85392', '85460', '80348', '81792')
       or ca_state in ('CA', 'WA', 'GA') or cs_sales_price > 500)
  and cs_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 2001
group by ca_zip order by ca_zip limit 100""",
    19: """
select i.i_brand_id, i.i_brand, sum(ss.ss_ext_sales_price) ext_price
from {S}.date_dim d, {S}.store_sales ss, {S}.item i, {S}.customer c,
     {S}.customer_address ca, {S}.store s
where d.d_date_sk = ss.ss_sold_date_sk and ss.ss_item_sk = i.i_item_sk
  and ss.ss_customer_sk = c.c_customer_sk
  and c.c_current_addr_sk = ca.ca_address_sk and ss.ss_store_sk = s.s_store_sk
  and substr(ca.ca_zip, 1, 5) <> substr(s.s_zip, 1, 5)
  and d.d_moy = 11 and d.d_year = 1998
group by i.i_brand_id, i.i_brand order by ext_price desc, i.i_brand_id limit 100""",
    20: """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(cs_ext_sales_price) as itemrevenue,
       sum(cs_ext_sales_price) * 100 / sum(sum(cs_ext_sales_price))
         over (partition by i_class) as revenueratio
from {S}.catalog_sales, {S}.item, {S}.date_dim
where cs_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and cs_sold_date_sk = d_date_sk
  and d_date between date '1999-02-22' and date '1999-03-24'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100""",
    21: """
select w_warehouse_name, i_item_id,
       sum(case when d_date < date '2000-03-11'
                then inv_quantity_on_hand else 0 end) as inv_before,
       sum(case when d_date >= date '2000-03-11'
                then inv_quantity_on_hand else 0 end) as inv_after
from {S}.inventory, {S}.warehouse, {S}.item, {S}.date_dim
where i_item_sk = inv_item_sk and inv_warehouse_sk = w_warehouse_sk
  and inv_date_sk = d_date_sk
  and i_current_price between 10.00 and 60.00
  and d_date between date '2000-02-10' and date '2000-04-10'
group by w_warehouse_name, i_item_id
having case when sum(case when d_date < date '2000-03-11'
                          then inv_quantity_on_hand else 0 end) > 0
            then cast(sum(case when d_date >= date '2000-03-11'
                               then inv_quantity_on_hand else 0 end)
                      as double)
                 / sum(case when d_date < date '2000-03-11'
                            then inv_quantity_on_hand else 0 end)
            else null end between 2.0 / 3.0 and 3.0 / 2.0
order by w_warehouse_name, i_item_id limit 100""",
    25: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) as store_sales_profit,
       sum(sr_net_loss) as store_returns_loss,
       sum(cs_net_profit) as catalog_sales_profit
from {S}.store_sales, {S}.store_returns, {S}.catalog_sales,
     {S}.date_dim d1, {S}.date_dim d2, {S}.date_dim d3, {S}.store, {S}.item
where d1.d_moy = 4 and d1.d_year = 2001 and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 4 and 10 and d2.d_year = 2001
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_moy between 4 and 10 and d3.d_year = 2001
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name limit 100""",
    26: """
select i_item_id, avg(cs_quantity) agg1, avg(cs_list_price) agg2,
       avg(cs_coupon_amt) agg3, avg(cs_sales_price) agg4
from {S}.catalog_sales, {S}.customer_demographics, {S}.date_dim,
     {S}.item, {S}.promotion
where cs_sold_date_sk = d_date_sk and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk and cs_promo_sk = p_promo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_tv = 'N') and d_year = 2000
group by i_item_id order by i_item_id limit 100""",
    28: """
select b1.lp lp1, b1.cnt cnt1, b2.lp lp2, b2.cnt cnt2, b3.lp lp3, b3.cnt cnt3
from (select avg(ss_list_price) lp, count(ss_list_price) cnt
      from {S}.store_sales
      where ss_quantity between 0 and 5
        and (ss_list_price between 8 and 18
             or ss_coupon_amt between 459 and 1459
             or ss_wholesale_cost between 57 and 77)) b1,
     (select avg(ss_list_price) lp, count(ss_list_price) cnt
      from {S}.store_sales
      where ss_quantity between 6 and 10
        and (ss_list_price between 90 and 100
             or ss_coupon_amt between 2323 and 3323
             or ss_wholesale_cost between 31 and 51)) b2,
     (select avg(ss_list_price) lp, count(ss_list_price) cnt
      from {S}.store_sales
      where ss_quantity between 11 and 15
        and (ss_list_price between 142 and 152
             or ss_coupon_amt between 12214 and 13214
             or ss_wholesale_cost between 79 and 99)) b3""",
    29: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) as store_sales_quantity,
       sum(sr_return_quantity) as store_returns_quantity,
       sum(cs_quantity) as catalog_sales_quantity
from {S}.store_sales, {S}.store_returns, {S}.catalog_sales,
     {S}.date_dim d1, {S}.date_dim d2, {S}.date_dim d3, {S}.store, {S}.item
where d1.d_moy = 9 and d1.d_year = 1999 and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 9 and 12 and d2.d_year = 1999
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk and d3.d_year in (1999, 2000, 2001)
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name limit 100""",
    30: """
with customer_total_return as (
  select wr_returning_customer_sk as ctr_customer_sk,
         ca_state as ctr_state, sum(wr_return_amt) as ctr_total_return
  from {S}.web_returns, {S}.date_dim, {S}.customer_address
  where wr_returned_date_sk = d_date_sk and d_year = 2002
    and wr_refunded_addr_sk = ca_address_sk
  group by wr_returning_customer_sk, ca_state)
select c_customer_id, c_first_name, c_last_name, ctr_total_return
from customer_total_return ctr1, {S}.customer_address, {S}.customer
where ctr1.ctr_total_return > (select avg(ctr_total_return) * 1.2
                               from customer_total_return ctr2
                               where ctr1.ctr_state = ctr2.ctr_state)
  and ca_address_sk = c_current_addr_sk and ca_state = 'GA'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, c_first_name, c_last_name, ctr_total_return
limit 100""",
    32: """
select sum(cs_ext_discount_amt) as excess_discount_amount
from {S}.catalog_sales, {S}.item, {S}.date_dim
where i_manufact_id = 939 and i_item_sk = cs_item_sk
  and d_date between date '2000-01-27' and date '2000-04-26'
  and d_date_sk = cs_sold_date_sk
  and cs_ext_discount_amt > (
    select 1.3 * avg(cs_ext_discount_amt)
    from {S}.catalog_sales, {S}.date_dim
    where cs_item_sk = i_item_sk
      and d_date between date '2000-01-27' and date '2000-04-26'
      and d_date_sk = cs_sold_date_sk)
limit 100""",
    33: """
with ss as (
  select i_manufact_id, sum(ss_ext_sales_price) total_sales
  from {S}.store_sales, {S}.date_dim, {S}.customer_address, {S}.item
  where i_item_sk = ss_item_sk and ss_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 1 and ss_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_manufact_id),
 cs as (
  select i_manufact_id, sum(cs_ext_sales_price) total_sales
  from {S}.catalog_sales, {S}.date_dim, {S}.customer_address, {S}.item
  where i_item_sk = cs_item_sk and cs_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 1 and cs_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_manufact_id),
 ws as (
  select i_manufact_id, sum(ws_ext_sales_price) total_sales
  from {S}.web_sales, {S}.date_dim, {S}.customer_address, {S}.item
  where i_item_sk = ws_item_sk and ws_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 1 and ws_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_manufact_id)
select i_manufact_id, sum(total_sales) total_sales
from (select * from ss union all select * from cs union all select * from ws)
group by i_manufact_id order by total_sales, i_manufact_id limit 100""",
    34: """
select c_last_name, c_first_name, ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from {S}.store_sales, {S}.date_dim, {S}.store,
           {S}.household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and (d_dom between 1 and 3 or d_dom between 25 and 28)
        and (hd_buy_potential = '>10000' or hd_buy_potential = 'Unknown')
        and hd_vehicle_count > 0
        and case when hd_vehicle_count > 0
                 then cast(hd_dep_count as double) / hd_vehicle_count
                 else null end > 1.2
        and d_year in (1999, 2000, 2001)
        and s_county in ('AL County 2', 'GA County 4')
      group by ss_ticket_number, ss_customer_sk) dn, {S}.customer
where ss_customer_sk = c_customer_sk and cnt between 2 and 20
order by c_last_name, c_first_name, ss_ticket_number desc, cnt""",
    37: """
select i_item_id, i_item_desc, i_current_price
from {S}.item, {S}.inventory, {S}.date_dim, {S}.catalog_sales
where i_current_price between 68 and 98
  and inv_item_sk = i_item_sk and d_date_sk = inv_date_sk
  and d_date between date '2000-02-01' and date '2000-04-01'
  and i_manufact_id in (677, 940, 694, 808)
  and inv_quantity_on_hand between 100 and 500
  and cs_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id limit 100""",
    38: """
select count(*) from (
  select distinct c_last_name, c_first_name, d_date
  from {S}.store_sales, {S}.date_dim, {S}.customer
  where ss_sold_date_sk = d_date_sk and ss_customer_sk = c_customer_sk
    and d_month_seq between 348 and 359
  intersect
  select distinct c_last_name, c_first_name, d_date
  from {S}.catalog_sales, {S}.date_dim, {S}.customer
  where cs_sold_date_sk = d_date_sk and cs_bill_customer_sk = c_customer_sk
    and d_month_seq between 348 and 359
  intersect
  select distinct c_last_name, c_first_name, d_date
  from {S}.web_sales, {S}.date_dim, {S}.customer
  where ws_sold_date_sk = d_date_sk and ws_bill_customer_sk = c_customer_sk
    and d_month_seq between 348 and 359) hot_cust
limit 100""",
    40: """
select w_state, i_item_id,
  sum(case when d_date < date '2000-03-11'
           then cs_sales_price - coalesce(cr_refunded_cash, 0)
           else 0 end) as sales_before,
  sum(case when d_date >= date '2000-03-11'
           then cs_sales_price - coalesce(cr_refunded_cash, 0)
           else 0 end) as sales_after
from {S}.catalog_sales
  left outer join {S}.catalog_returns
    on (cs_order_number = cr_order_number and cs_item_sk = cr_item_sk),
  {S}.warehouse, {S}.item, {S}.date_dim
where i_current_price between 10.00 and 60.00 and i_item_sk = cs_item_sk
  and cs_warehouse_sk = w_warehouse_sk and cs_sold_date_sk = d_date_sk
  and d_date between date '2000-02-10' and date '2000-04-10'
group by w_state, i_item_id
order by w_state, i_item_id limit 100""",
    41: """
select distinct i_product_name
from {S}.item i1
where i_manufact_id between 700 and 1000
  and (select count(*) as item_cnt from {S}.item
       where i_manufact = i1.i_manufact
         and (((i_category = 'Women' and i_color in ('red', 'blue')
                and i_units in ('Each', 'Case'))
            or (i_category = 'Women' and i_color in ('green', 'black')
                and i_units in ('Dozen', 'Pallet'))
            or (i_category = 'Men' and i_color in ('white', 'yellow')
                and i_units in ('Each', 'Case'))
            or (i_category = 'Men' and i_color in ('purple', 'orange')
                and i_units in ('Dozen', 'Pallet')))
           or ((i_category = 'Women' and i_color in ('brown', 'pink')
                and i_units in ('Each', 'Case'))
            or (i_category = 'Women' and i_color in ('cyan', 'magenta')
                and i_units in ('Dozen', 'Pallet'))
            or (i_category = 'Men' and i_color in ('ivory', 'gold')
                and i_units in ('Each', 'Case'))
            or (i_category = 'Men' and i_color in ('red', 'green')
                and i_units in ('Dozen', 'Pallet'))))) > 0
order by i_product_name limit 100""",
    42: """
select d.d_year, i.i_category_id, i.i_category, sum(ss.ss_ext_sales_price)
from {S}.date_dim d, {S}.store_sales ss, {S}.item i
where d.d_date_sk = ss.ss_sold_date_sk and ss.ss_item_sk = i.i_item_sk
  and i.i_manufact_id > 0 and d.d_moy = 11 and d.d_year = 2000
group by d.d_year, i.i_category_id, i.i_category
order by 4 desc, d.d_year, i.i_category_id, i.i_category limit 100""",
    43: """
select s_store_name, s_store_id,
       sum(case when d_day_name = 'Sunday' then ss_sales_price else null end) sun_sales,
       sum(case when d_day_name = 'Monday' then ss_sales_price else null end) mon_sales,
       sum(case when d_day_name = 'Tuesday' then ss_sales_price else null end) tue_sales,
       sum(case when d_day_name = 'Wednesday' then ss_sales_price else null end) wed_sales,
       sum(case when d_day_name = 'Thursday' then ss_sales_price else null end) thu_sales,
       sum(case when d_day_name = 'Friday' then ss_sales_price else null end) fri_sales,
       sum(case when d_day_name = 'Saturday' then ss_sales_price else null end) sat_sales
from {S}.date_dim, {S}.store_sales, {S}.store
where d_date_sk = ss_sold_date_sk and s_store_sk = ss_store_sk
  and s_state = 'TN' and d_year = 2000
group by s_store_name, s_store_id
order by s_store_name, s_store_id limit 100""",
    45: """
select ca_zip, ca_city, sum(ws_sales_price)
from {S}.web_sales, {S}.customer, {S}.customer_address, {S}.date_dim, {S}.item
where ws_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk and ws_item_sk = i_item_sk
  and (substr(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405', '86475',
                                '85392', '85460', '80348', '81792')
       or i_item_id in (select i_item_id from {S}.item
                        where i_item_sk in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)))
  and ws_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 2001
group by ca_zip, ca_city order by ca_zip, ca_city limit 100""",
    46: """
select c_last_name, c_first_name, current_addr.ca_city, bought_city,
       ss_ticket_number, amt, profit
from (select ss_ticket_number, ss_customer_sk, ca_city bought_city,
             sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from {S}.store_sales, {S}.date_dim, {S}.store,
           {S}.household_demographics, {S}.customer_address
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
        and (hd_dep_count = 4 or hd_vehicle_count = 3)
        and d_dow in (6, 0) and d_year in (1999, 2000, 2001)
        and s_city in ('Fairview', 'Midway')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     {S}.customer cu, {S}.customer_address current_addr
where ss_customer_sk = cu.c_customer_sk
  and cu.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number
limit 100""",
    48: """
select sum(ss_quantity)
from {S}.store_sales, {S}.store, {S}.customer_demographics,
     {S}.customer_address, {S}.date_dim
where s_store_sk = ss_store_sk and ss_sold_date_sk = d_date_sk and d_year = 2000
  and ((cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'M'
        and cd_education_status = '4 yr Degree'
        and ss_sales_price between 100.00 and 150.00)
    or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'D'
        and cd_education_status = '2 yr Degree'
        and ss_sales_price between 50.00 and 100.00)
    or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'S'
        and cd_education_status = 'College'
        and ss_sales_price between 150.00 and 200.00))
  and ((ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('CO', 'OH', 'TX') and ss_net_profit between 0 and 2000)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('OR', 'MN', 'KY') and ss_net_profit between 150 and 3000)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('VA', 'CA', 'MS') and ss_net_profit between 50 and 25000))""",
    50: """
select s_store_name, s_store_id,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk <= 30) then 1 else 0 end) as d30,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk > 30)
                 and (sr_returned_date_sk - ss_sold_date_sk <= 60) then 1 else 0 end) as d60,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk > 60) then 1 else 0 end) as dmore
from {S}.store_sales, {S}.store_returns, {S}.store, {S}.date_dim d2
where ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk
  and sr_returned_date_sk = d2.d_date_sk and d2.d_year = 2001 and d2.d_moy = 8
  and ss_store_sk = s_store_sk
group by s_store_name, s_store_id
order by s_store_name, s_store_id limit 100""",
    52: """
select d.d_year, i.i_brand_id, i.i_brand, sum(ss.ss_ext_sales_price) ext_price
from {S}.date_dim d, {S}.store_sales ss, {S}.item i
where d.d_date_sk = ss.ss_sold_date_sk and ss.ss_item_sk = i.i_item_sk
  and i.i_manufact_id = 1 and d.d_moy = 11 and d.d_year = 2000
group by d.d_year, i.i_brand, i.i_brand_id
order by d.d_year, ext_price desc, i.i_brand_id limit 100""",
    53: """
select * from (
  select i_manufact_id, sum(ss_sales_price) sum_sales,
         avg(sum(ss_sales_price)) over (partition by i_manufact_id)
           avg_quarterly_sales
  from {S}.item, {S}.store_sales, {S}.date_dim, {S}.store
  where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and d_month_seq in (360, 361, 362, 363, 364, 365, 366, 367, 368,
                        369, 370, 371)
    and ((i_category in ('Books', 'Children', 'Electronics')
          and i_class in ('class01', 'class02', 'class03'))
      or (i_category in ('Women', 'Music', 'Men')
          and i_class in ('class12', 'class13', 'class07')))
  group by i_manufact_id, d_qoy) tmp1
where case when avg_quarterly_sales > 0
           then abs(sum_sales - avg_quarterly_sales) / avg_quarterly_sales
           else null end > 0.1
order by avg_quarterly_sales, sum_sales, i_manufact_id limit 100""",
    55: """
select i.i_brand_id brand_id, i.i_brand brand, sum(ss.ss_ext_sales_price) ext_price
from {S}.date_dim d, {S}.store_sales ss, {S}.item i
where d.d_date_sk = ss.ss_sold_date_sk and ss.ss_item_sk = i.i_item_sk
  and i.i_manufact_id = 28 and d.d_moy = 11 and d.d_year = 1999
group by i.i_brand, i.i_brand_id order by ext_price desc, i.i_brand_id limit 100""",
    56: """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) total_sales
  from {S}.store_sales, {S}.date_dim, {S}.customer_address, {S}.item
  where i_item_id in (select i_item_id from {S}.item
                      where i_color in ('red', 'blue', 'green'))
    and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2 and ss_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_item_id),
cs as (
  select i_item_id, sum(cs_ext_sales_price) total_sales
  from {S}.catalog_sales, {S}.date_dim, {S}.customer_address, {S}.item
  where i_item_id in (select i_item_id from {S}.item
                      where i_color in ('red', 'blue', 'green'))
    and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2 and cs_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_item_id),
ws as (
  select i_item_id, sum(ws_ext_sales_price) total_sales
  from {S}.web_sales, {S}.date_dim, {S}.customer_address, {S}.item
  where i_item_id in (select i_item_id from {S}.item
                      where i_color in ('red', 'blue', 'green'))
    and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2 and ws_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_item_id)
select i_item_id, sum(total_sales) total_sales
from (select * from ss union all select * from cs union all
      select * from ws) tmp1
group by i_item_id order by total_sales, i_item_id limit 100""",
    58: """
with ss_items as (
  select i_item_id item_id, sum(ss_ext_sales_price) ss_item_rev
  from {S}.store_sales, {S}.item, {S}.date_dim
  where ss_item_sk = i_item_sk
    and d_date in (select d_date from {S}.date_dim
                   where d_week_seq = (select d_week_seq from {S}.date_dim
                                       where d_date = date '2000-01-03'))
    and ss_sold_date_sk = d_date_sk
  group by i_item_id),
cs_items as (
  select i_item_id item_id, sum(cs_ext_sales_price) cs_item_rev
  from {S}.catalog_sales, {S}.item, {S}.date_dim
  where cs_item_sk = i_item_sk
    and d_date in (select d_date from {S}.date_dim
                   where d_week_seq = (select d_week_seq from {S}.date_dim
                                       where d_date = date '2000-01-03'))
    and cs_sold_date_sk = d_date_sk
  group by i_item_id),
ws_items as (
  select i_item_id item_id, sum(ws_ext_sales_price) ws_item_rev
  from {S}.web_sales, {S}.item, {S}.date_dim
  where ws_item_sk = i_item_sk
    and d_date in (select d_date from {S}.date_dim
                   where d_week_seq = (select d_week_seq from {S}.date_dim
                                       where d_date = date '2000-01-03'))
    and ws_sold_date_sk = d_date_sk
  group by i_item_id)
select ss_items.item_id, ss_item_rev,
       ss_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
         ss_dev,
       cs_item_rev,
       cs_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
         cs_dev,
       ws_item_rev,
       ws_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
         ws_dev,
       (ss_item_rev + cs_item_rev + ws_item_rev) / 3 average
from ss_items, cs_items, ws_items
where ss_items.item_id = cs_items.item_id
  and ss_items.item_id = ws_items.item_id
  and ss_item_rev between 0.9 * cs_item_rev and 1.1 * cs_item_rev
  and ss_item_rev between 0.9 * ws_item_rev and 1.1 * ws_item_rev
  and cs_item_rev between 0.9 * ss_item_rev and 1.1 * ss_item_rev
  and cs_item_rev between 0.9 * ws_item_rev and 1.1 * ws_item_rev
  and ws_item_rev between 0.9 * ss_item_rev and 1.1 * ss_item_rev
  and ws_item_rev between 0.9 * cs_item_rev and 1.1 * cs_item_rev
order by ss_items.item_id, ss_item_rev limit 100""",
    59: """
with wss as (
  select d_week_seq, ss_store_sk,
    sum(case when d_day_name = 'Sunday' then ss_sales_price else null end)
      sun_sales,
    sum(case when d_day_name = 'Monday' then ss_sales_price else null end)
      mon_sales,
    sum(case when d_day_name = 'Tuesday' then ss_sales_price else null end)
      tue_sales,
    sum(case when d_day_name = 'Wednesday' then ss_sales_price else null end)
      wed_sales,
    sum(case when d_day_name = 'Thursday' then ss_sales_price else null end)
      thu_sales,
    sum(case when d_day_name = 'Friday' then ss_sales_price else null end)
      fri_sales,
    sum(case when d_day_name = 'Saturday' then ss_sales_price else null end)
      sat_sales
  from {S}.store_sales, {S}.date_dim
  where d_date_sk = ss_sold_date_sk
  group by d_week_seq, ss_store_sk)
select s_store_name1, s_store_id1, d_week_seq1,
       sun_sales1 / sun_sales2, mon_sales1 / mon_sales2,
       tue_sales1 / tue_sales2, wed_sales1 / wed_sales2,
       thu_sales1 / thu_sales2, fri_sales1 / fri_sales2,
       sat_sales1 / sat_sales2
from (select s_store_name s_store_name1, wss.d_week_seq d_week_seq1,
             s_store_id s_store_id1, sun_sales sun_sales1,
             mon_sales mon_sales1, tue_sales tue_sales1,
             wed_sales wed_sales1, thu_sales thu_sales1,
             fri_sales fri_sales1, sat_sales sat_sales1
      from wss, {S}.store, {S}.date_dim d
      where d.d_week_seq = wss.d_week_seq and ss_store_sk = s_store_sk
        and d_month_seq between 348 and 350) y,
     (select s_store_name s_store_name2, wss.d_week_seq d_week_seq2,
             s_store_id s_store_id2, sun_sales sun_sales2,
             mon_sales mon_sales2, tue_sales tue_sales2,
             wed_sales wed_sales2, thu_sales thu_sales2,
             fri_sales fri_sales2, sat_sales sat_sales2
      from wss, {S}.store, {S}.date_dim d
      where d.d_week_seq = wss.d_week_seq and ss_store_sk = s_store_sk
        and d_month_seq between 360 and 362) x
where s_store_id1 = s_store_id2 and d_week_seq1 = d_week_seq2 - 52
order by s_store_name1, s_store_id1, d_week_seq1
limit 100""",
    60: """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) total_sales
  from {S}.store_sales, {S}.date_dim, {S}.customer_address, {S}.item
  where i_item_sk = ss_item_sk
    and i_item_id in (select i_item_id from {S}.item where i_category = 'Music')
    and ss_sold_date_sk = d_date_sk and d_year = 1998 and d_moy = 9
    and ss_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_item_id),
 cs as (
  select i_item_id, sum(cs_ext_sales_price) total_sales
  from {S}.catalog_sales, {S}.date_dim, {S}.customer_address, {S}.item
  where i_item_sk = cs_item_sk
    and i_item_id in (select i_item_id from {S}.item where i_category = 'Music')
    and cs_sold_date_sk = d_date_sk and d_year = 1998 and d_moy = 9
    and cs_bill_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_item_id),
 ws as (
  select i_item_id, sum(ws_ext_sales_price) total_sales
  from {S}.web_sales, {S}.date_dim, {S}.customer_address, {S}.item
  where i_item_sk = ws_item_sk
    and i_item_id in (select i_item_id from {S}.item where i_category = 'Music')
    and ws_sold_date_sk = d_date_sk and d_year = 1998 and d_moy = 9
    and ws_bill_addr_sk = ca_address_sk and ca_gmt_offset = -5
  group by i_item_id)
select i_item_id, sum(total_sales) total_sales
from (select * from ss union all select * from cs union all select * from ws)
group by i_item_id order by i_item_id, total_sales limit 100""",
    61: """
select promotions, total,
       cast(promotions as double) / cast(total as double) * 100 as ratio
from (select sum(ss_ext_sales_price) promotions
      from {S}.store_sales, {S}.store, {S}.promotion, {S}.date_dim,
           {S}.customer, {S}.customer_address, {S}.item
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_promo_sk = p_promo_sk and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk and ss_item_sk = i_item_sk
        and ca_gmt_offset = -5 and i_category = 'Jewelry'
        and (p_channel_dmail = 'Y' or p_channel_email = 'Y' or p_channel_tv = 'Y')
        and d_year = 1998 and d_moy = 11) promotional_sales,
     (select sum(ss_ext_sales_price) total
      from {S}.store_sales, {S}.store, {S}.date_dim,
           {S}.customer, {S}.customer_address, {S}.item
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk and ss_item_sk = i_item_sk
        and ca_gmt_offset = -5 and i_category = 'Jewelry'
        and d_year = 1998 and d_moy = 11) all_sales
order by promotions, total limit 100""",
    62: """
select substr(w_warehouse_name, 1, 20), sm_type, web_name,
       sum(case when (ws_ship_date_sk - ws_sold_date_sk <= 30) then 1 else 0 end) as d30,
       sum(case when (ws_ship_date_sk - ws_sold_date_sk > 30)
                 and (ws_ship_date_sk - ws_sold_date_sk <= 60) then 1 else 0 end) as d60,
       sum(case when (ws_ship_date_sk - ws_sold_date_sk > 60) then 1 else 0 end) as dmore
from {S}.web_sales, {S}.warehouse, {S}.ship_mode, {S}.web_site, {S}.date_dim
where ws_ship_date_sk = d_date_sk and ws_warehouse_sk = w_warehouse_sk
  and ws_ship_mode_sk = sm_ship_mode_sk and ws_web_site_sk = web_site_sk
  and d_year = 2000
group by substr(w_warehouse_name, 1, 20), sm_type, web_name
order by 1, sm_type, web_name limit 100""",
    64: """
with cs_ui as (
  select cs_item_sk,
         sum(cs_ext_list_price) as sale,
         sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)
           as refund
  from {S}.catalog_sales, {S}.catalog_returns
  where cs_item_sk = cr_item_sk and cs_order_number = cr_order_number
  group by cs_item_sk
  having sum(cs_ext_list_price) >
         2 * sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)),
cross_sales as (
  select i_product_name product_name, i_item_sk item_sk,
         s_store_name store_name, s_zip store_zip,
         ad1.ca_street_number b_street_number,
         ad1.ca_street_name b_street_name,
         ad1.ca_city b_city, ad1.ca_zip b_zip,
         ad2.ca_street_number c_street_number,
         ad2.ca_street_name c_street_name,
         ad2.ca_city c_city, ad2.ca_zip c_zip,
         d1.d_year as syear, d2.d_year as fsyear, d3.d_year s2year,
         count(*) cnt,
         sum(ss_wholesale_cost) s1, sum(ss_list_price) s2,
         sum(ss_coupon_amt) s3
  from {S}.store_sales, {S}.store_returns, cs_ui,
       {S}.date_dim d1, {S}.date_dim d2, {S}.date_dim d3,
       {S}.store, {S}.customer,
       {S}.customer_demographics cd1, {S}.customer_demographics cd2,
       {S}.promotion,
       {S}.household_demographics hd1, {S}.household_demographics hd2,
       {S}.customer_address ad1, {S}.customer_address ad2,
       {S}.income_band ib1, {S}.income_band ib2, {S}.item
  where ss_store_sk = s_store_sk and ss_sold_date_sk = d1.d_date_sk
    and ss_customer_sk = c_customer_sk and ss_cdemo_sk = cd1.cd_demo_sk
    and ss_hdemo_sk = hd1.hd_demo_sk and ss_addr_sk = ad1.ca_address_sk
    and ss_item_sk = i_item_sk
    and ss_item_sk = sr_item_sk and ss_ticket_number = sr_ticket_number
    and ss_item_sk = cs_ui.cs_item_sk
    and c_current_cdemo_sk = cd2.cd_demo_sk
    and c_current_hdemo_sk = hd2.hd_demo_sk
    and c_current_addr_sk = ad2.ca_address_sk
    and c_first_sales_date_sk = d2.d_date_sk
    and c_first_shipto_date_sk = d3.d_date_sk
    and ss_promo_sk = p_promo_sk
    and hd1.hd_income_band_sk = ib1.ib_income_band_sk
    and hd2.hd_income_band_sk = ib2.ib_income_band_sk
    and cd1.cd_marital_status <> cd2.cd_marital_status
    and i_color in ('purple', 'gold', 'red', 'cyan', 'blue', 'green')
    and i_current_price between 20 and 120
    and i_current_price between 21 and 130
  group by i_product_name, i_item_sk, s_store_name, s_zip,
           ad1.ca_street_number, ad1.ca_street_name, ad1.ca_city,
           ad1.ca_zip, ad2.ca_street_number, ad2.ca_street_name,
           ad2.ca_city, ad2.ca_zip, d1.d_year, d2.d_year, d3.d_year)
select cs1.product_name, cs1.store_name, cs1.store_zip,
       cs1.b_street_number, cs1.b_street_name, cs1.b_city, cs1.b_zip,
       cs1.c_street_number, cs1.c_street_name, cs1.c_city, cs1.c_zip,
       cs1.syear, cs1.cnt,
       cs1.s1 as s11, cs1.s2 as s21, cs1.s3 as s31,
       cs2.s1 as s12, cs2.s2 as s22, cs2.s3 as s32,
       cs2.syear as syear2, cs2.cnt as cnt2
from cross_sales cs1, cross_sales cs2
where cs1.item_sk = cs2.item_sk and cs1.syear = 2000
  and cs2.syear = 2000 + 1 and cs2.cnt <= cs1.cnt
  and cs1.store_name = cs2.store_name and cs1.store_zip = cs2.store_zip
order by cs1.product_name, cs1.store_name, cnt2, s11, s12""",
    65: """
select s_store_name, i_item_desc, sc.revenue, i_current_price,
       i_wholesale_cost, i_brand
from {S}.store, {S}.item,
     (select ss_store_sk, avg(revenue) as ave
      from (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
            from {S}.store_sales, {S}.date_dim
            where ss_sold_date_sk = d_date_sk and d_month_seq between 1212 and 1223
            group by ss_store_sk, ss_item_sk) sa
      group by ss_store_sk) sb,
     (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
      from {S}.store_sales, {S}.date_dim
      where ss_sold_date_sk = d_date_sk and d_month_seq between 1212 and 1223
      group by ss_store_sk, ss_item_sk) sc
where sb.ss_store_sk = sc.ss_store_sk and sc.revenue <= 0.1 * sb.ave
  and s_store_sk = sc.ss_store_sk and i_item_sk = sc.ss_item_sk
order by s_store_name, i_item_desc, sc.revenue limit 100""",
    66: """
select w_warehouse_name, w_warehouse_sq_ft, w_city, w_state, w_country,
       ship_carriers, year_,
       sum(jan_sales) as jan_sales, sum(feb_sales) as feb_sales,
       sum(mar_sales) as mar_sales, sum(apr_sales) as apr_sales,
       sum(may_sales) as may_sales, sum(jun_sales) as jun_sales,
       sum(jul_sales) as jul_sales, sum(aug_sales) as aug_sales,
       sum(sep_sales) as sep_sales, sum(oct_sales) as oct_sales,
       sum(nov_sales) as nov_sales, sum(dec_sales) as dec_sales,
       sum(jan_net) as jan_net, sum(dec_net) as dec_net
from (
  select w_warehouse_name, w_warehouse_sq_ft, w_city, w_state, w_country,
         'Carrier0' || ',' || 'Carrier1' as ship_carriers,
         d_year as year_,
         sum(case when d_moy = 1 then ws_ext_sales_price * ws_quantity
                  else 0 end) as jan_sales,
         sum(case when d_moy = 2 then ws_ext_sales_price * ws_quantity
                  else 0 end) as feb_sales,
         sum(case when d_moy = 3 then ws_ext_sales_price * ws_quantity
                  else 0 end) as mar_sales,
         sum(case when d_moy = 4 then ws_ext_sales_price * ws_quantity
                  else 0 end) as apr_sales,
         sum(case when d_moy = 5 then ws_ext_sales_price * ws_quantity
                  else 0 end) as may_sales,
         sum(case when d_moy = 6 then ws_ext_sales_price * ws_quantity
                  else 0 end) as jun_sales,
         sum(case when d_moy = 7 then ws_ext_sales_price * ws_quantity
                  else 0 end) as jul_sales,
         sum(case when d_moy = 8 then ws_ext_sales_price * ws_quantity
                  else 0 end) as aug_sales,
         sum(case when d_moy = 9 then ws_ext_sales_price * ws_quantity
                  else 0 end) as sep_sales,
         sum(case when d_moy = 10 then ws_ext_sales_price * ws_quantity
                  else 0 end) as oct_sales,
         sum(case when d_moy = 11 then ws_ext_sales_price * ws_quantity
                  else 0 end) as nov_sales,
         sum(case when d_moy = 12 then ws_ext_sales_price * ws_quantity
                  else 0 end) as dec_sales,
         sum(case when d_moy = 1 then ws_net_paid * ws_quantity
                  else 0 end) as jan_net,
         sum(case when d_moy = 12 then ws_net_paid * ws_quantity
                  else 0 end) as dec_net
  from {S}.web_sales, {S}.warehouse, {S}.date_dim, {S}.time_dim,
       {S}.ship_mode
  where ws_warehouse_sk = w_warehouse_sk and ws_sold_date_sk = d_date_sk
    and ws_sold_time_sk = t_time_sk and ws_ship_mode_sk = sm_ship_mode_sk
    and d_year = 2001 and t_time between 30838 and 30838 + 28800
    and sm_carrier in ('Carrier0', 'Carrier1')
  group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_state,
           w_country, d_year
  union all
  select w_warehouse_name, w_warehouse_sq_ft, w_city, w_state, w_country,
         'Carrier0' || ',' || 'Carrier1' as ship_carriers,
         d_year as year_,
         sum(case when d_moy = 1 then cs_sales_price * cs_quantity
                  else 0 end) as jan_sales,
         sum(case when d_moy = 2 then cs_sales_price * cs_quantity
                  else 0 end) as feb_sales,
         sum(case when d_moy = 3 then cs_sales_price * cs_quantity
                  else 0 end) as mar_sales,
         sum(case when d_moy = 4 then cs_sales_price * cs_quantity
                  else 0 end) as apr_sales,
         sum(case when d_moy = 5 then cs_sales_price * cs_quantity
                  else 0 end) as may_sales,
         sum(case when d_moy = 6 then cs_sales_price * cs_quantity
                  else 0 end) as jun_sales,
         sum(case when d_moy = 7 then cs_sales_price * cs_quantity
                  else 0 end) as jul_sales,
         sum(case when d_moy = 8 then cs_sales_price * cs_quantity
                  else 0 end) as aug_sales,
         sum(case when d_moy = 9 then cs_sales_price * cs_quantity
                  else 0 end) as sep_sales,
         sum(case when d_moy = 10 then cs_sales_price * cs_quantity
                  else 0 end) as oct_sales,
         sum(case when d_moy = 11 then cs_sales_price * cs_quantity
                  else 0 end) as nov_sales,
         sum(case when d_moy = 12 then cs_sales_price * cs_quantity
                  else 0 end) as dec_sales,
         sum(case when d_moy = 1 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) as jan_net,
         sum(case when d_moy = 12 then cs_net_paid_inc_tax * cs_quantity
                  else 0 end) as dec_net
  from {S}.catalog_sales, {S}.warehouse, {S}.date_dim, {S}.time_dim,
       {S}.ship_mode
  where cs_warehouse_sk = w_warehouse_sk and cs_sold_date_sk = d_date_sk
    and cs_sold_time_sk = t_time_sk and cs_ship_mode_sk = sm_ship_mode_sk
    and d_year = 2001 and t_time between 30838 and 30838 + 28800
    and sm_carrier in ('Carrier0', 'Carrier1')
  group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_state,
           w_country, d_year) x
group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_state, w_country,
         ship_carriers, year_
order by w_warehouse_name limit 100""",
    68: """
select c_last_name, c_first_name, current_addr.ca_city, bought_city,
       ss_ticket_number, extended_price, extended_tax, list_price
from (select ss_ticket_number, ss_customer_sk, ca_city bought_city,
             sum(ss_ext_sales_price) extended_price,
             sum(ss_ext_list_price) list_price,
             sum(ss_ext_tax) extended_tax
      from {S}.store_sales, {S}.date_dim, {S}.store,
           {S}.household_demographics, {S}.customer_address
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
        and d_dom between 1 and 2 and (hd_dep_count = 4 or hd_vehicle_count = 3)
        and d_year in (1999, 2000, 2001) and s_city in ('Midway', 'Fairview')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     {S}.customer cu, {S}.customer_address current_addr
where ss_customer_sk = cu.c_customer_sk
  and cu.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, ss_ticket_number limit 100""",
    69: """
select cd_gender, cd_marital_status, cd_education_status, count(*) cnt1,
       cd_purchase_estimate, count(*) cnt2
from {S}.customer c, {S}.customer_address ca, {S}.customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and ca_state in ('KY', 'GA', 'NM')
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from {S}.store_sales, {S}.date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk and d_year = 2001
                and d_moy between 4 and 6)
  and not exists (select * from {S}.web_sales, {S}.date_dim
                  where c.c_customer_sk = ws_bill_customer_sk
                    and ws_sold_date_sk = d_date_sk and d_year = 2001
                    and d_moy between 4 and 6)
  and not exists (select * from {S}.catalog_sales, {S}.date_dim
                  where c.c_customer_sk = cs_ship_customer_sk
                    and cs_sold_date_sk = d_date_sk and d_year = 2001
                    and d_moy between 4 and 6)
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate limit 100""",
    71: """
select i_brand_id brand_id, i_brand brand, t_hour, t_minute,
       sum(ext_price) ext_price
from {S}.item,
     (select ws_ext_sales_price as ext_price,
             ws_sold_date_sk as sold_date_sk,
             ws_item_sk as sold_item_sk,
             ws_sold_time_sk as time_sk
      from {S}.web_sales, {S}.date_dim
      where d_date_sk = ws_sold_date_sk and d_moy = 11 and d_year = 1999
      union all
      select cs_ext_sales_price as ext_price,
             cs_sold_date_sk as sold_date_sk,
             cs_item_sk as sold_item_sk,
             cs_sold_time_sk as time_sk
      from {S}.catalog_sales, {S}.date_dim
      where d_date_sk = cs_sold_date_sk and d_moy = 11 and d_year = 1999
      union all
      select ss_ext_sales_price as ext_price,
             ss_sold_date_sk as sold_date_sk,
             ss_item_sk as sold_item_sk,
             ss_sold_time_sk as time_sk
      from {S}.store_sales, {S}.date_dim
      where d_date_sk = ss_sold_date_sk and d_moy = 11 and d_year = 1999
     ) tmp, {S}.time_dim
where sold_item_sk = i_item_sk and i_manufact_id between 4 and 500
  and time_sk = t_time_sk and t_am_pm = 'AM'
group by i_brand, i_brand_id, t_hour, t_minute
order by ext_price desc, i_brand_id, t_hour, t_minute""",
    73: """
select c_last_name, c_first_name, ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from {S}.store_sales, {S}.date_dim, {S}.store,
           {S}.household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk and d_dom between 1 and 2
        and (hd_buy_potential = '>10000' or hd_buy_potential = 'Unknown')
        and hd_vehicle_count > 0 and d_year in (1999, 2000, 2001)
        and s_county in ('AL County 1', 'CA County 2', 'GA County 3')
      group by ss_ticket_number, ss_customer_sk) dj, {S}.customer
where ss_customer_sk = c_customer_sk and cnt between 1 and 5
order by cnt desc, c_last_name asc limit 100""",
    74: """
with year_total as (
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name, d_year as year_,
         sum(ss_net_paid) year_total, 's' sale_type
  from {S}.customer, {S}.store_sales, {S}.date_dim
  where c_customer_sk = ss_customer_sk and ss_sold_date_sk = d_date_sk
    and d_year in (2001, 2002)
  group by c_customer_id, c_first_name, c_last_name, d_year
  union all
  select c_customer_id customer_id, c_first_name customer_first_name,
         c_last_name customer_last_name, d_year as year_,
         sum(ws_net_paid) year_total, 'w' sale_type
  from {S}.customer, {S}.web_sales, {S}.date_dim
  where c_customer_sk = ws_bill_customer_sk and ws_sold_date_sk = d_date_sk
    and d_year in (2001, 2002)
  group by c_customer_id, c_first_name, c_last_name, d_year)
select t_s_secyear.customer_id, t_s_secyear.customer_first_name,
       t_s_secyear.customer_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.sale_type = 's' and t_w_firstyear.sale_type = 'w'
  and t_s_secyear.sale_type = 's' and t_w_secyear.sale_type = 'w'
  and t_s_firstyear.year_ = 2001 and t_s_secyear.year_ = 2001 + 1
  and t_w_firstyear.year_ = 2001 and t_w_secyear.year_ = 2001 + 1
  and t_s_firstyear.year_total > 0 and t_w_firstyear.year_total > 0
  and case when t_w_firstyear.year_total > 0
           then t_w_secyear.year_total / t_w_firstyear.year_total
           else null end
    > case when t_s_firstyear.year_total > 0
           then t_s_secyear.year_total / t_s_firstyear.year_total
           else null end
order by 1, 3, 2
limit 100""",
    76: """
select channel, col_name, d_year, d_qoy, i_category, count(*) sales_cnt,
       sum(ext_sales_price) sales_amt
from (
  select 'store' as channel, 'ss_store_sk' col_name, d_year, d_qoy,
         i_category, ss_ext_sales_price ext_sales_price
  from {S}.store_sales, {S}.item, {S}.date_dim
  where ss_store_sk is null and ss_sold_date_sk = d_date_sk
    and ss_item_sk = i_item_sk
  union all
  select 'web' as channel, 'ws_ship_customer_sk' col_name, d_year, d_qoy,
         i_category, ws_ext_sales_price ext_sales_price
  from {S}.web_sales, {S}.item, {S}.date_dim
  where ws_ship_customer_sk is null and ws_sold_date_sk = d_date_sk
    and ws_item_sk = i_item_sk
  union all
  select 'catalog' as channel, 'cs_ship_addr_sk' col_name, d_year, d_qoy,
         i_category, cs_ext_sales_price ext_sales_price
  from {S}.catalog_sales, {S}.item, {S}.date_dim
  where cs_ship_addr_sk is null and cs_sold_date_sk = d_date_sk
    and cs_item_sk = i_item_sk) foo
group by channel, col_name, d_year, d_qoy, i_category
order by channel, col_name, d_year, d_qoy, i_category
limit 100""",
    79: """
select c_last_name, c_first_name, substr(s_city, 1, 30), ss_ticket_number,
       amt, profit
from (select ss_ticket_number, ss_customer_sk, s_city,
             sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from {S}.store_sales, {S}.date_dim, {S}.store,
           {S}.household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and (hd_dep_count = 6 or hd_vehicle_count > 2)
        and d_dow = 1 and d_year in (1999, 2000, 2001)
        and s_number_employees between 200 and 295
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, s_city) ms,
     {S}.customer
where ss_customer_sk = c_customer_sk
order by c_last_name, c_first_name, substr(s_city, 1, 30), profit limit 100""",
    82: """
select i_item_id, i_item_desc, i_current_price
from {S}.item, {S}.inventory, {S}.date_dim, {S}.store_sales
where i_current_price between 62 and 92
  and inv_item_sk = i_item_sk and d_date_sk = inv_date_sk
  and d_date between date '2000-05-25' and date '2000-07-24'
  and i_manufact_id in (129, 270, 821, 423)
  and inv_quantity_on_hand between 100 and 500
  and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id limit 100""",
    83: """
with sr_items as (
  select i_item_id item_id, sum(sr_return_quantity) sr_item_qty
  from {S}.store_returns, {S}.item, {S}.date_dim
  where sr_item_sk = i_item_sk
    and d_date in (select d_date from {S}.date_dim
                   where d_week_seq in (select d_week_seq from {S}.date_dim
                                        where d_date in (date '2000-06-30',
                                                         date '2000-09-27',
                                                         date '2000-11-17')))
    and sr_returned_date_sk = d_date_sk
  group by i_item_id),
cr_items as (
  select i_item_id item_id, sum(cr_return_quantity) cr_item_qty
  from {S}.catalog_returns, {S}.item, {S}.date_dim
  where cr_item_sk = i_item_sk
    and d_date in (select d_date from {S}.date_dim
                   where d_week_seq in (select d_week_seq from {S}.date_dim
                                        where d_date in (date '2000-06-30',
                                                         date '2000-09-27',
                                                         date '2000-11-17')))
    and cr_returned_date_sk = d_date_sk
  group by i_item_id),
wr_items as (
  select i_item_id item_id, sum(wr_return_quantity) wr_item_qty
  from {S}.web_returns, {S}.item, {S}.date_dim
  where wr_item_sk = i_item_sk
    and d_date in (select d_date from {S}.date_dim
                   where d_week_seq in (select d_week_seq from {S}.date_dim
                                        where d_date in (date '2000-06-30',
                                                         date '2000-09-27',
                                                         date '2000-11-17')))
    and wr_returned_date_sk = d_date_sk
  group by i_item_id)
select sr_items.item_id, sr_item_qty,
       sr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
         sr_dev,
       cr_item_qty,
       cr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
         cr_dev,
       wr_item_qty,
       wr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
         wr_dev,
       (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 average
from sr_items, cr_items, wr_items
where sr_items.item_id = cr_items.item_id
  and sr_items.item_id = wr_items.item_id
order by sr_items.item_id, sr_item_qty
limit 100""",
    84: """
select c_customer_id as customer_id,
       coalesce(c_last_name, '') || ', ' || coalesce(c_first_name, '')
         as customername
from {S}.customer, {S}.customer_address, {S}.customer_demographics,
     {S}.household_demographics, {S}.income_band, {S}.store_returns
where ca_city = 'City115' and c_current_addr_sk = ca_address_sk
  and ib_lower_bound >= 30000 and ib_upper_bound <= 30000 + 50000
  and ib_income_band_sk = hd_income_band_sk
  and cd_demo_sk = c_current_cdemo_sk
  and hd_demo_sk = c_current_hdemo_sk
  and sr_cdemo_sk = cd_demo_sk
order by c_customer_id limit 100""",
    87: """
select count(*) from (
  (select distinct c_last_name, c_first_name, d_date
   from {S}.store_sales, {S}.date_dim, {S}.customer
   where ss_sold_date_sk = d_date_sk and ss_customer_sk = c_customer_sk
     and d_month_seq between 348 and 359)
  except
  (select distinct c_last_name, c_first_name, d_date
   from {S}.catalog_sales, {S}.date_dim, {S}.customer
   where cs_sold_date_sk = d_date_sk and cs_bill_customer_sk = c_customer_sk
     and d_month_seq between 348 and 359)
  except
  (select distinct c_last_name, c_first_name, d_date
   from {S}.web_sales, {S}.date_dim, {S}.customer
   where ws_sold_date_sk = d_date_sk and ws_bill_customer_sk = c_customer_sk
     and d_month_seq between 348 and 359)) cool_cust""",
    88: """
select * from
 (select count(*) h8_30_to_9 from {S}.store_sales, {S}.household_demographics,
   {S}.time_dim, {S}.store
  where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
    and ss_store_sk = s_store_sk and t_hour = 8 and t_minute >= 30
    and ((hd_dep_count = 4 and hd_vehicle_count <= 6)
         or (hd_dep_count = 2 and hd_vehicle_count <= 4)
         or (hd_dep_count = 0 and hd_vehicle_count <= 2))
    and s_store_name = 'ese') s1,
 (select count(*) h9_to_9_30 from {S}.store_sales, {S}.household_demographics,
   {S}.time_dim, {S}.store
  where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
    and ss_store_sk = s_store_sk and t_hour = 9 and t_minute < 30
    and ((hd_dep_count = 4 and hd_vehicle_count <= 6)
         or (hd_dep_count = 2 and hd_vehicle_count <= 4)
         or (hd_dep_count = 0 and hd_vehicle_count <= 2))
    and s_store_name = 'ese') s2,
 (select count(*) h9_30_to_10 from {S}.store_sales, {S}.household_demographics,
   {S}.time_dim, {S}.store
  where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
    and ss_store_sk = s_store_sk and t_hour = 9 and t_minute >= 30
    and ((hd_dep_count = 4 and hd_vehicle_count <= 6)
         or (hd_dep_count = 2 and hd_vehicle_count <= 4)
         or (hd_dep_count = 0 and hd_vehicle_count <= 2))
    and s_store_name = 'ese') s3""",
    90: """
select cast(amc as double) / cast(pmc as double) am_pm_ratio
from (select count(*) amc from {S}.web_sales, {S}.household_demographics,
       {S}.time_dim, {S}.web_page
      where ws_sold_time_sk = t_time_sk and ws_bill_hdemo_sk = hd_demo_sk
        and ws_web_page_sk = wp_web_page_sk and t_hour between 8 and 9
        and hd_dep_count = 6 and wp_char_count between 5000 and 5200) at1,
     (select count(*) pmc from {S}.web_sales, {S}.household_demographics,
       {S}.time_dim, {S}.web_page
      where ws_sold_time_sk = t_time_sk and ws_bill_hdemo_sk = hd_demo_sk
        and ws_web_page_sk = wp_web_page_sk and t_hour between 19 and 20
        and hd_dep_count = 6 and wp_char_count between 5000 and 5200) pt
order by am_pm_ratio limit 100""",
    91: """
select cc_call_center_id call_center, cc_name, cc_manager manager,
       sum(cr_net_loss) returns_loss
from {S}.call_center, {S}.catalog_returns, {S}.date_dim, {S}.customer,
     {S}.customer_address, {S}.customer_demographics,
     {S}.household_demographics
where cr_call_center_sk = cc_call_center_sk
  and cr_returned_date_sk = d_date_sk
  and cr_returning_customer_sk = c_customer_sk
  and cd_demo_sk = c_current_cdemo_sk
  and hd_demo_sk = c_current_hdemo_sk
  and ca_address_sk = c_current_addr_sk
  and d_year = 1998 and d_moy = 12
  and ((cd_marital_status = 'M' and cd_education_status = 'Unknown')
    or (cd_marital_status = 'D' and cd_education_status = 'Advanced Degree'))
  and hd_buy_potential like 'Unk%'
  and ca_gmt_offset = -5
group by cc_call_center_id, cc_name, cc_manager
order by returns_loss desc""",
    92: """
select sum(ws_ext_discount_amt) as excess_discount_amount
from {S}.web_sales, {S}.item, {S}.date_dim
where i_manufact_id = 350 and i_item_sk = ws_item_sk
  and d_date between date '2000-01-27' and date '2000-04-26'
  and d_date_sk = ws_sold_date_sk
  and ws_ext_discount_amt > (
    select 1.3 * avg(ws_ext_discount_amt)
    from {S}.web_sales, {S}.date_dim
    where ws_item_sk = i_item_sk
      and d_date between date '2000-01-27' and date '2000-04-26'
      and d_date_sk = ws_sold_date_sk)
order by sum(ws_ext_discount_amt) limit 100""",
    93: """
select ss_customer_sk, sum(act_sales) sumsales
from (select ss_item_sk, ss_ticket_number, ss_customer_sk,
             case when sr_return_quantity is not null
                  then (ss_quantity - sr_return_quantity) * ss_sales_price
                  else ss_quantity * ss_sales_price end act_sales
      from ({S}.store_sales left join {S}.store_returns
        on sr_item_sk = ss_item_sk and sr_ticket_number = ss_ticket_number)
        join {S}.reason on sr_reason_sk = r_reason_sk
      where r_reason_desc = 'reason 28') t
group by ss_customer_sk
order by sumsales, ss_customer_sk limit 100""",
    94: """
select count(distinct ws_order_number) as order_count,
       sum(ws_ext_ship_cost) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from {S}.web_sales ws1, {S}.date_dim, {S}.customer_address, {S}.web_site
where d_date between date '1999-02-01' and date '1999-04-01'
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk and ca_state = 'IL'
  and ws1.ws_web_site_sk = web_site_sk and web_company_name = 'pri'
  and exists (select * from {S}.web_sales ws2
              where ws1.ws_order_number = ws2.ws_order_number
                and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
  and not exists (select * from {S}.web_returns wr1
                  where ws1.ws_order_number = wr1.wr_order_number)
order by count(distinct ws_order_number) limit 100""",
    95: """
with ws_wh as (
  select ws1.ws_order_number
  from {S}.web_sales ws1, {S}.web_sales ws2
  where ws1.ws_order_number = ws2.ws_order_number
    and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk
)
select count(distinct ws.ws_order_number) as order_count,
       sum(ws.ws_ext_ship_cost) as total_shipping_cost,
       sum(ws.ws_net_profit) as total_net_profit
from {S}.web_sales ws, {S}.date_dim d, {S}.customer_address ca, {S}.web_site w
where d.d_date between date '1999-02-01' and date '1999-04-01'
  and ws.ws_ship_date_sk = d.d_date_sk
  and ws.ws_ship_addr_sk = ca.ca_address_sk and ca.ca_state = 'IL'
  and ws.ws_web_site_sk = w.web_site_sk and w.web_company_name = 'pri'
  and ws.ws_order_number in (select ws_order_number from ws_wh)
  and ws.ws_order_number in (
      select wr.wr_order_number from {S}.web_returns wr, ws_wh
      where wr.wr_order_number = ws_wh.ws_order_number)
order by count(distinct ws.ws_order_number) limit 100""",
    96: """
select count(*)
from {S}.store_sales ss, {S}.household_demographics hd, {S}.time_dim t, {S}.store s
where ss.ss_sold_time_sk = t.t_time_sk and ss.ss_hdemo_sk = hd.hd_demo_sk
  and ss.ss_store_sk = s.s_store_sk and t.t_hour = 20
  and hd.hd_dep_count = 7 order by count(*) limit 100""",
    97: """
with ssci as (
  select ss_customer_sk customer_sk, ss_item_sk item_sk
  from {S}.store_sales, {S}.date_dim
  where ss_sold_date_sk = d_date_sk and d_month_seq between 1200 and 1211
  group by ss_customer_sk, ss_item_sk),
 csci as (
  select cs_bill_customer_sk customer_sk, cs_item_sk item_sk
  from {S}.catalog_sales, {S}.date_dim
  where cs_sold_date_sk = d_date_sk and d_month_seq between 1200 and 1211
  group by cs_bill_customer_sk, cs_item_sk)
select sum(case when ssci.customer_sk is not null and csci.customer_sk is null
                then 1 else 0 end) store_only,
       sum(case when ssci.customer_sk is null and csci.customer_sk is not null
                then 1 else 0 end) catalog_only,
       sum(case when ssci.customer_sk is not null and csci.customer_sk is not null
                then 1 else 0 end) store_and_catalog
from ssci full outer join csci
  on (ssci.customer_sk = csci.customer_sk and ssci.item_sk = csci.item_sk)
limit 100""",
    98: """
select i_item_desc, i_category, i_class, i_current_price,
       sum(ss_ext_sales_price) as itemrevenue,
       sum(ss_ext_sales_price) * 100.0 /
         sum(sum(ss_ext_sales_price)) over (partition by i_class) as revenueratio
from {S}.store_sales, {S}.item, {S}.date_dim
where ss_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and ss_sold_date_sk = d_date_sk
  and d_date between date '1999-02-22' and date '1999-03-24'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio limit 100""",
    99: """
select substr(w_warehouse_name, 1, 20) wh, sm_type, cc_name,
       sum(case when cs_ship_date_sk - cs_sold_date_sk <= 7
                then 1 else 0 end) as d7,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 7
                 and cs_ship_date_sk - cs_sold_date_sk <= 14
                then 1 else 0 end) as d14,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 14
                 and cs_ship_date_sk - cs_sold_date_sk <= 21
                then 1 else 0 end) as d21,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 21
                 and cs_ship_date_sk - cs_sold_date_sk <= 28
                then 1 else 0 end) as d28,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 28
                then 1 else 0 end) as dmore
from {S}.catalog_sales, {S}.warehouse, {S}.ship_mode, {S}.call_center,
     {S}.date_dim
where d_month_seq between 348 and 359
  and cs_ship_date_sk = d_date_sk
  and cs_warehouse_sk = w_warehouse_sk
  and cs_ship_mode_sk = sm_ship_mode_sk
  and cs_call_center_sk = cc_call_center_sk
group by substr(w_warehouse_name, 1, 20), sm_type, cc_name
order by substr(w_warehouse_name, 1, 20), sm_type, cc_name
limit 100""",
}


def queries(schema: str = "tpcds.tiny") -> dict[int, str]:
    """The 64 TPC-DS queries against ``schema`` (e.g. 'tpcds.sf1')."""
    return {q: text.replace("{S}", schema) for q, text in _TEXTS.items()}
