"""TPC-H query corpus (spec text), parameterized by schema.

Reference: ``testing/trino-benchto-benchmarks/src/main/resources/benchmarks/
presto/tpch.yaml``. The port's own copy of ``trino_tpu/benchmarks/tpch.py``
(the same 22 query texts), so that scripts of the port such as
``chip_smoke.py`` run spec text without importing the JAX package.
"""


def queries(schema: str = "tpch.tiny") -> dict[int, str]:
    """The 22 TPC-H queries against ``schema`` (e.g. 'tpch.sf1')."""
    S = schema
    QUERIES = {
        1: f"""
    select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
           sum(l_extendedprice) as sum_base_price,
           sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
           avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
           avg(l_discount) as avg_disc, count(*) as count_order
    from {S}.lineitem
    where l_shipdate <= date '1998-12-01' - interval '90' day
    group by l_returnflag, l_linestatus
    order by l_returnflag, l_linestatus""",
        2: f"""
    select s.s_acctbal, s.s_name, n.n_name, p.p_partkey, p.p_mfgr
    from {S}.part p, {S}.supplier s, {S}.partsupp ps, {S}.nation n, {S}.region r
    where p.p_partkey = ps.ps_partkey and s.s_suppkey = ps.ps_suppkey
      and p.p_size = 15 and p.p_type like '%BRASS'
      and s.s_nationkey = n.n_nationkey and n.n_regionkey = r.r_regionkey
      and r.r_name = 'EUROPE'
      and ps.ps_supplycost = (
        select min(ps2.ps_supplycost)
        from {S}.partsupp ps2, {S}.supplier s2, {S}.nation n2, {S}.region r2
        where p.p_partkey = ps2.ps_partkey and s2.s_suppkey = ps2.ps_suppkey
          and s2.s_nationkey = n2.n_nationkey and n2.n_regionkey = r2.r_regionkey
          and r2.r_name = 'EUROPE')
    order by s.s_acctbal desc, n.n_name, s.s_name, p.p_partkey
    limit 100""",
        3: f"""
    select l.l_orderkey, sum(l.l_extendedprice * (1 - l.l_discount)) as revenue,
           o.o_orderdate, o.o_shippriority
    from {S}.customer c, {S}.orders o, {S}.lineitem l
    where c.c_mktsegment = 'BUILDING' and c.c_custkey = o.o_custkey
      and l.l_orderkey = o.o_orderkey and o.o_orderdate < date '1995-03-15'
      and l.l_shipdate > date '1995-03-15'
    group by l.l_orderkey, o.o_orderdate, o.o_shippriority
    order by revenue desc, o.o_orderdate limit 10""",
        4: f"""
    select o_orderpriority, count(*) as order_count
    from {S}.orders
    where o_orderdate >= date '1993-07-01'
      and o_orderdate < date '1993-07-01' + interval '3' month
      and exists (select 1 from {S}.lineitem
                  where l_orderkey = o_orderkey and l_commitdate < l_receiptdate)
    group by o_orderpriority order by o_orderpriority""",
        5: f"""
    select n.n_name, sum(l.l_extendedprice * (1 - l.l_discount)) as revenue
    from {S}.customer c, {S}.orders o, {S}.lineitem l, {S}.supplier s,
         {S}.nation n, {S}.region r
    where c.c_custkey = o.o_custkey and l.l_orderkey = o.o_orderkey
      and l.l_suppkey = s.s_suppkey and c.c_nationkey = s.s_nationkey
      and s.s_nationkey = n.n_nationkey and n.n_regionkey = r.r_regionkey
      and r.r_name = 'ASIA' and o.o_orderdate >= date '1994-01-01'
      and o.o_orderdate < date '1994-01-01' + interval '1' year
    group by n.n_name order by revenue desc""",
        6: f"""
    select sum(l_extendedprice * l_discount) as revenue
    from {S}.lineitem
    where l_shipdate >= date '1994-01-01'
      and l_shipdate < date '1994-01-01' + interval '1' year
      and l_discount between 0.05 and 0.07 and l_quantity < 24""",
        7: f"""
    select supp_nation, cust_nation, l_year, sum(volume) as revenue
    from (
      select n1.n_name as supp_nation, n2.n_name as cust_nation,
             extract(year from l.l_shipdate) as l_year,
             l.l_extendedprice * (1 - l.l_discount) as volume
      from {S}.supplier s, {S}.lineitem l, {S}.orders o, {S}.customer c,
           {S}.nation n1, {S}.nation n2
      where s.s_suppkey = l.l_suppkey and o.o_orderkey = l.l_orderkey
        and c.c_custkey = o.o_custkey and s.s_nationkey = n1.n_nationkey
        and c.c_nationkey = n2.n_nationkey
        and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
          or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
        and l.l_shipdate between date '1995-01-01' and date '1996-12-31'
    ) as shipping
    group by supp_nation, cust_nation, l_year
    order by supp_nation, cust_nation, l_year""",
        8: f"""
    select o_year, sum(case when nation = 'BRAZIL' then volume else 0 end) / sum(volume) as mkt_share
    from (
      select extract(year from o.o_orderdate) as o_year,
             l.l_extendedprice * (1 - l.l_discount) as volume,
             n2.n_name as nation
      from {S}.part p, {S}.supplier s, {S}.lineitem l, {S}.orders o,
           {S}.customer c, {S}.nation n1, {S}.nation n2, {S}.region r
      where p.p_partkey = l.l_partkey and s.s_suppkey = l.l_suppkey
        and l.l_orderkey = o.o_orderkey and o.o_custkey = c.c_custkey
        and c.c_nationkey = n1.n_nationkey and n1.n_regionkey = r.r_regionkey
        and r.r_name = 'AMERICA' and s.s_nationkey = n2.n_nationkey
        and o.o_orderdate between date '1995-01-01' and date '1996-12-31'
        and p.p_type = 'ECONOMY ANODIZED STEEL'
    ) as all_nations
    group by o_year order by o_year""",
        9: f"""
    select nation, o_year, sum(amount) as sum_profit
    from (
      select n.n_name as nation, extract(year from o.o_orderdate) as o_year,
             l.l_extendedprice * (1 - l.l_discount) - ps.ps_supplycost * l.l_quantity as amount
      from {S}.part p, {S}.supplier s, {S}.lineitem l, {S}.partsupp ps,
           {S}.orders o, {S}.nation n
      where s.s_suppkey = l.l_suppkey and ps.ps_suppkey = l.l_suppkey
        and ps.ps_partkey = l.l_partkey and p.p_partkey = l.l_partkey
        and o.o_orderkey = l.l_orderkey and s.s_nationkey = n.n_nationkey
        and p.p_name like '%green%'
    ) as profit
    group by nation, o_year order by nation, o_year desc""",
        10: f"""
    select c.c_custkey, c.c_name,
           sum(l.l_extendedprice * (1 - l.l_discount)) as revenue,
           c.c_acctbal, n.n_name, c.c_address, c.c_phone, c.c_comment
    from {S}.customer c, {S}.orders o, {S}.lineitem l, {S}.nation n
    where c.c_custkey = o.o_custkey and l.l_orderkey = o.o_orderkey
      and o.o_orderdate >= date '1993-10-01'
      and o.o_orderdate < date '1993-10-01' + interval '3' month
      and l.l_returnflag = 'R' and c.c_nationkey = n.n_nationkey
    group by c.c_custkey, c.c_name, c.c_acctbal, c.c_phone, n.n_name,
             c.c_address, c.c_comment
    order by revenue desc limit 20""",
        11: f"""
    select ps.ps_partkey, sum(ps.ps_supplycost * ps.ps_availqty) as value
    from {S}.partsupp ps, {S}.supplier s, {S}.nation n
    where ps.ps_suppkey = s.s_suppkey and s.s_nationkey = n.n_nationkey
      and n.n_name = 'GERMANY'
    group by ps.ps_partkey
    having sum(ps.ps_supplycost * ps.ps_availqty) > (
      select sum(ps2.ps_supplycost * ps2.ps_availqty) * 0.0001
      from {S}.partsupp ps2, {S}.supplier s2, {S}.nation n2
      where ps2.ps_suppkey = s2.s_suppkey and s2.s_nationkey = n2.n_nationkey
        and n2.n_name = 'GERMANY')
    order by value desc""",
        12: f"""
    select l.l_shipmode,
           sum(case when o.o_orderpriority = '1-URGENT' or o.o_orderpriority = '2-HIGH'
                    then 1 else 0 end) as high_line_count,
           sum(case when o.o_orderpriority <> '1-URGENT' and o.o_orderpriority <> '2-HIGH'
                    then 1 else 0 end) as low_line_count
    from {S}.orders o, {S}.lineitem l
    where o.o_orderkey = l.l_orderkey and l.l_shipmode in ('MAIL', 'SHIP')
      and l.l_commitdate < l.l_receiptdate and l.l_shipdate < l.l_commitdate
      and l.l_receiptdate >= date '1994-01-01'
      and l.l_receiptdate < date '1994-01-01' + interval '1' year
    group by l.l_shipmode order by l.l_shipmode""",
        13: f"""
    select c_count, count(*) as custdist
    from (
      select c.c_custkey, count(o.o_orderkey) as c_count
      from {S}.customer c left join {S}.orders o
        on c.c_custkey = o.o_custkey and o.o_comment not like '%special%requests%'
      group by c.c_custkey
    ) as c_orders
    group by c_count order by custdist desc, c_count desc""",
        14: f"""
    select 100.00 * sum(case when p.p_type like 'PROMO%'
                             then l.l_extendedprice * (1 - l.l_discount) else 0 end)
           / sum(l.l_extendedprice * (1 - l.l_discount)) as promo_revenue
    from {S}.lineitem l, {S}.part p
    where l.l_partkey = p.p_partkey and l.l_shipdate >= date '1995-09-01'
      and l.l_shipdate < date '1995-09-01' + interval '1' month""",
        15: f"""
    with revenue as (
      select l_suppkey as supplier_no,
             sum(l_extendedprice * (1 - l_discount)) as total_revenue
      from {S}.lineitem
      where l_shipdate >= date '1996-01-01'
        and l_shipdate < date '1996-01-01' + interval '3' month
      group by l_suppkey
    )
    select s.s_suppkey, s.s_name, s.s_address, s.s_phone, r.total_revenue
    from {S}.supplier s, revenue r
    where s.s_suppkey = r.supplier_no
      and r.total_revenue = (select max(total_revenue) from revenue)
    order by s.s_suppkey""",
        16: f"""
    select p.p_brand, p.p_type, p.p_size, count(distinct ps.ps_suppkey) as supplier_cnt
    from {S}.partsupp ps, {S}.part p
    where p.p_partkey = ps.ps_partkey and p.p_brand <> 'Brand#45'
      and p.p_type not like 'MEDIUM POLISHED%' and p.p_size in (49, 14, 23, 45, 19, 3, 36, 9)
      and ps.ps_suppkey not in (
        select s_suppkey from {S}.supplier where s_comment like '%Customer%Complaints%')
    group by p.p_brand, p.p_type, p.p_size
    order by supplier_cnt desc, p.p_brand, p.p_type, p.p_size limit 50""",
        17: f"""
    select sum(l1.l_extendedprice) / 7.0 as avg_yearly
    from {S}.lineitem l1, {S}.part p
    where p.p_partkey = l1.l_partkey and p.p_brand = 'Brand#23'
      and p.p_container = 'MED BOX'
      and l1.l_quantity < (
        select 0.2 * avg(l2.l_quantity) from {S}.lineitem l2
        where l2.l_partkey = p.p_partkey)""",
        18: f"""
    select c.c_name, c.c_custkey, o.o_orderkey, o.o_orderdate, o.o_totalprice,
           sum(l.l_quantity)
    from {S}.customer c, {S}.orders o, {S}.lineitem l
    where o.o_orderkey in (
        select l_orderkey from {S}.lineitem
        group by l_orderkey having sum(l_quantity) > 150)
      and c.c_custkey = o.o_custkey and o.o_orderkey = l.l_orderkey
    group by c.c_name, c.c_custkey, o.o_orderkey, o.o_orderdate, o.o_totalprice
    order by o.o_totalprice desc, o.o_orderdate limit 100""",
        19: f"""
    select sum(l.l_extendedprice * (1 - l.l_discount)) as revenue
    from {S}.lineitem l, {S}.part p
    where (p.p_partkey = l.l_partkey and p.p_brand = 'Brand#12'
       and p.p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
       and l.l_quantity >= 1 and l.l_quantity <= 11
       and p.p_size between 1 and 5 and l.l_shipmode in ('AIR', 'REG AIR')
       and l.l_shipinstruct = 'DELIVER IN PERSON')
    or (p.p_partkey = l.l_partkey and p.p_brand = 'Brand#23'
       and p.p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
       and l.l_quantity >= 10 and l.l_quantity <= 20
       and p.p_size between 1 and 10 and l.l_shipmode in ('AIR', 'REG AIR')
       and l.l_shipinstruct = 'DELIVER IN PERSON')
    or (p.p_partkey = l.l_partkey and p.p_brand = 'Brand#34'
       and p.p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
       and l.l_quantity >= 20 and l.l_quantity <= 30
       and p.p_size between 1 and 15 and l.l_shipmode in ('AIR', 'REG AIR')
       and l.l_shipinstruct = 'DELIVER IN PERSON')""",
        20: f"""
    select s.s_name, s.s_address
    from {S}.supplier s, {S}.nation n
    where s.s_suppkey in (
        select ps_suppkey from {S}.partsupp
        where ps_partkey in (select p_partkey from {S}.part where p_name like 'forest%')
          and ps_availqty > (
            select 0.5 * sum(l_quantity) from {S}.lineitem
            where l_partkey = ps_partkey and l_suppkey = ps_suppkey
              and l_shipdate >= date '1994-01-01'
              and l_shipdate < date '1994-01-01' + interval '1' year))
      and s.s_nationkey = n.n_nationkey and n.n_name = 'CANADA'
    order by s.s_name""",
        21: f"""
    select s.s_name, count(*) as numwait
    from {S}.supplier s, {S}.lineitem l1, {S}.orders o, {S}.nation n
    where s.s_suppkey = l1.l_suppkey and o.o_orderkey = l1.l_orderkey
      and o.o_orderstatus = 'F' and l1.l_receiptdate > l1.l_commitdate
      and exists (select 1 from {S}.lineitem l2
                  where l2.l_orderkey = l1.l_orderkey
                    and l2.l_suppkey <> l1.l_suppkey)
      and not exists (select 1 from {S}.lineitem l3
                      where l3.l_orderkey = l1.l_orderkey
                        and l3.l_suppkey <> l1.l_suppkey
                        and l3.l_receiptdate > l3.l_commitdate)
      and s.s_nationkey = n.n_nationkey and n.n_name = 'SAUDI ARABIA'
    group by s.s_name order by numwait desc, s.s_name limit 100""",
        22: f"""
    select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
    from (
      select substr(c.c_phone, 1, 2) as cntrycode, c.c_acctbal
      from {S}.customer c
      where substr(c.c_phone, 1, 2) in ('13', '31', '23', '29', '30', '18', '17')
        and c.c_acctbal > (
          select avg(c2.c_acctbal) from {S}.customer c2
          where c2.c_acctbal > 0.00
            and substr(c2.c_phone, 1, 2) in ('13', '31', '23', '29', '30', '18', '17'))
        and not exists (select 1 from {S}.orders o where o.o_custkey = c.c_custkey)
    ) as custsale
    group by cntrycode order by cntrycode""",
    }
    return QUERIES
