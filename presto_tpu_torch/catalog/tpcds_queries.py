"""The TPC-DS queries the port runs, in the engine's SQL dialect: the
port's second workload, run by `chip_smoke.py` on the card and held
against the JAX package by tests/test_torch_tpcds.py.

- `ANSWERS`: the spec-shaped queries of tests/test_tpcds_answers.py (the
  same texts; that file holds them against sqlite).
- `SHAPES`: the star-join and cross-channel shapes of
  tests/test_tpcds_queries.py.
- `ANALYTIC`: TPC-DS spec queries cut to the generator's columns (it has
  no i_class, d_month_seq, s_company_name or c_last_name; i_size stands
  in for i_class): windows, ROLLUP, set operations, cross and non-equi
  joins, the sorted aggregates, numeric and date functions.

`QUERIES` is all three, 43 texts.
"""

ANSWERS = {
    "q1_returns_above_store_avg": """
with customer_total_return as (
  select sr_customer_sk as ctr_customer_sk, sr_store_sk as ctr_store_sk,
         sum(sr_return_amt) as ctr_total_return
  from store_returns, date_dim
  where sr_returned_date_sk = d_date_sk and d_year = 2000
  group by sr_customer_sk, sr_store_sk
), store_avg as (
  select ctr_store_sk as sa_store_sk,
         avg(ctr_total_return) * 1.2 as sa_bar
  from customer_total_return group by ctr_store_sk
)
select ctr_customer_sk, ctr_store_sk, ctr_total_return
from customer_total_return, store_avg
where ctr_store_sk = sa_store_sk and ctr_total_return > sa_bar
order by ctr_customer_sk, ctr_store_sk limit 100
""",
    "q13_demographic_averages": """
select avg(ss_quantity) as aq, avg(ss_ext_sales_price) as ap,
       avg(ss_ext_wholesale_cost) as aw, sum(ss_ext_wholesale_cost) as sw
from store_sales, store, customer_demographics, date_dim
where s_store_sk = ss_store_sk and d_date_sk = ss_sold_date_sk
  and d_year = 2001 and cd_demo_sk = ss_cdemo_sk
  and cd_marital_status = 'M' and cd_education_status = 'Degree'
  and ss_quantity between 1 and 60
""",
    "q15_catalog_by_zip": """
select ca_zip, sum(cs_sales_price) as s
from catalog_sales, customer, customer_address, date_dim
where cs_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and (ca_state in ('CA', 'WA', 'GA') or cs_sales_price > 80)
  and cs_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 2001
group by ca_zip order by ca_zip limit 100
""",
    "q19_brand_by_manufact": """
select i_brand_id, i_brand, i_manufact_id, sum(ss_ext_sales_price) as s
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manufact_id between 1 and 200 and d_moy = 11 and d_year = 1999
group by i_brand_id, i_brand, i_manufact_id
order by s desc, i_brand_id limit 50
""",
    "q21_inventory_before_after": """
select w_warehouse_name, i_item_id,
       sum(case when d_date_sk < 2451179 then inv_quantity_on_hand
                else 0 end) as inv_before,
       sum(case when d_date_sk >= 2451179 then inv_quantity_on_hand
                else 0 end) as inv_after
from inventory, warehouse, item, date_dim
where i_item_sk = inv_item_sk and inv_warehouse_sk = w_warehouse_sk
  and inv_date_sk = d_date_sk and d_year = 1998
  and i_current_price between 0.99 and 49.99
group by w_warehouse_name, i_item_id
order by w_warehouse_name, i_item_id limit 100
""",
    "q25_store_catalog_chain": """
select i_item_id, s_store_id, s_store_name,
       sum(ss_net_profit) as store_profit,
       sum(cs_net_profit) as catalog_profit
from (
  select ss_item_sk, ss_net_profit, sr_ticket_number, cs_net_profit,
         ss_store_sk
  from store_sales, store_returns, catalog_sales
  where ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
) chain, item, store
where ss_item_sk = i_item_sk and ss_store_sk = s_store_sk
group by i_item_id, s_store_id, s_store_name
order by i_item_id, s_store_id limit 100
""",
    "q26_catalog_demographics": """
select i_item_id, avg(cs_quantity) as agg1, avg(cs_list_price) as agg2,
       avg(cs_sales_price) as agg4
from catalog_sales, customer, customer_demographics, date_dim, item
where cs_sold_date_sk = d_date_sk and cs_item_sk = i_item_sk
  and cs_bill_customer_sk = c_customer_sk
  and c_current_cdemo_sk = cd_demo_sk and cd_gender = 'F'
  and cd_marital_status = 'S' and d_year = 2000
group by i_item_id order by i_item_id limit 100
""",
    "q33_cross_channel_by_manufact": """
select i_manufact_id, sum(total_sales) as total_sales
from (
  select i_manufact_id, sum(ss_ext_sales_price) as total_sales
  from store_sales, date_dim, item
  where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
    and d_year = 1998 and d_moy = 5
  group by i_manufact_id
  union all
  select i_manufact_id, sum(cs_ext_sales_price) as total_sales
  from catalog_sales, date_dim, item
  where cs_sold_date_sk = d_date_sk and cs_item_sk = i_item_sk
    and d_year = 1998 and d_moy = 5
  group by i_manufact_id
  union all
  select i_manufact_id, sum(ws_ext_sales_price) as total_sales
  from web_sales, date_dim, item
  where ws_sold_date_sk = d_date_sk and ws_item_sk = i_item_sk
    and d_year = 1998 and d_moy = 5
  group by i_manufact_id
) channels
group by i_manufact_id order by total_sales desc, i_manufact_id limit 100
""",
    "q37_item_inventory_window": """
select i_item_id, i_current_price, sum(cs_quantity) as q
from item, inventory, catalog_sales
where i_current_price between 20 and 50
  and inv_item_sk = i_item_sk
  and inv_quantity_on_hand between 100 and 500
  and cs_item_sk = i_item_sk
group by i_item_id, i_current_price
order by i_item_id limit 50
""",
    "q43_store_by_dow": """
select s_store_name, s_store_id,
       sum(case when d_dow = 0 then ss_sales_price else 0 end) as sun_sales,
       sum(case when d_dow = 1 then ss_sales_price else 0 end) as mon_sales,
       sum(case when d_dow = 5 then ss_sales_price else 0 end) as fri_sales,
       sum(case when d_dow = 6 then ss_sales_price else 0 end) as sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk and s_store_sk = ss_store_sk
  and d_year = 2000
group by s_store_name, s_store_id
order by s_store_name, s_store_id limit 100
""",
    "q46_tickets_by_city": """
select ss_ticket_number, ss_customer_sk, ca_city,
       sum(ss_coupon_amt) as amt, sum(ss_net_profit) as profit
from store_sales, date_dim, store, household_demographics,
     customer_address
where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
  and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
  and (hd_dep_count = 4 or hd_vehicle_count = 3)
  and d_dow in (6, 0) and d_year = 1999
group by ss_ticket_number, ss_customer_sk, ca_city
order by ss_ticket_number limit 100
""",
    "q48_or_banded_quantity": """
select sum(ss_quantity) as q
from store_sales, store, customer_demographics, customer_address, date_dim
where s_store_sk = ss_store_sk and ss_sold_date_sk = d_date_sk
  and d_year = 2000 and ss_cdemo_sk = cd_demo_sk
  and ss_addr_sk = ca_address_sk and ca_country = 'United States'
  and ((cd_marital_status = 'M' and cd_education_status = 'College'
        and ss_sales_price between 50.00 and 100.00)
    or (cd_marital_status = 'S' and cd_education_status = '2 yr Degree'
        and ss_sales_price between 10.00 and 60.00))
""",
    "q52_brand_by_eom": """
select d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manufact_id = 77 and d_moy = 12 and d_year = 1999
group by d_year, i_brand_id, i_brand
order by d_year, ext_price desc, i_brand_id limit 50
""",
    "q55_brand_for_manager": """
select i_brand_id, i_brand, sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
  and i_manufact_id = 28 and d_moy = 11 and d_year = 1999
group by i_brand_id, i_brand
order by ext_price desc, i_brand_id limit 50
""",
    "q62_web_ship_buckets": """
select w_warehouse_name, sm_type, web_name,
       sum(case when ws_ship_date_sk - ws_sold_date_sk <= 30
                then 1 else 0 end) as d30,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 30
                 and ws_ship_date_sk - ws_sold_date_sk <= 60
                then 1 else 0 end) as d60,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 60
                then 1 else 0 end) as d90
from web_sales, warehouse, ship_mode, web_site, date_dim
where ws_ship_date_sk = d_date_sk and d_year = 2000
  and ws_warehouse_sk = w_warehouse_sk
  and ws_ship_mode_sk = sm_ship_mode_sk
  and ws_web_site_sk = web_site_sk
group by w_warehouse_name, sm_type, web_name
order by w_warehouse_name, sm_type, web_name limit 100
""",
    "q65_store_item_vs_avg": """
with sales_by_item as (
  select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
  from store_sales, date_dim
  where ss_sold_date_sk = d_date_sk and d_year = 2000
  group by ss_store_sk, ss_item_sk
), store_avg as (
  select ss_store_sk as sa_store_sk, avg(revenue) as ave
  from sales_by_item group by ss_store_sk
)
select s_store_name, i_item_id, revenue
from store, item, sales_by_item, store_avg
where ss_store_sk = sa_store_sk and revenue <= 0.1 * ave
  and s_store_sk = ss_store_sk and i_item_sk = ss_item_sk
order by s_store_name, i_item_id limit 100
""",
    "q73_ticket_counts": """
select c_customer_sk, cnt
from (
  select ss_ticket_number, ss_customer_sk, count(*) as cnt
  from store_sales, date_dim, store, household_demographics
  where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
    and ss_hdemo_sk = hd_demo_sk
    and d_dom between 1 and 2 and d_year = 2000
    and hd_buy_potential = '1001-5000' and hd_vehicle_count > 0
  group by ss_ticket_number, ss_customer_sk
) tickets, customer
where ss_customer_sk = c_customer_sk and cnt between 1 and 5
order by cnt desc, c_customer_sk limit 100
""",
    "q88_hour_buckets": """
select sum(case when t_hour between 8 and 11 then 1 else 0 end) as morning,
       sum(case when t_hour between 12 and 15 then 1 else 0 end) as midday,
       sum(case when t_hour between 16 and 19 then 1 else 0 end) as evening
from store_sales, household_demographics, time_dim
where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
  and hd_dep_count = 3
""",
    "q92_web_above_item_avg": """
with item_avg as (
  select ws_item_sk as ia_item_sk,
         1.3 * avg(ws_ext_ship_cost) as bar
  from web_sales group by ws_item_sk
)
select sum(ws_ext_ship_cost) as excess
from web_sales, item_avg
where ws_item_sk = ia_item_sk and ws_ext_ship_cost > bar
""",
    "q96_hour_window_count": """
select count(*) as cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
  and ss_store_sk = s_store_sk and t_hour = 20
  and hd_dep_count = 7
""",
    "q99_catalog_ship_buckets": """
select w_warehouse_name, sm_type, cc_name,
       sum(case when cs_ship_date_sk - cs_sold_date_sk <= 30
                then 1 else 0 end) as d30,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 30
                 and cs_ship_date_sk - cs_sold_date_sk <= 60
                then 1 else 0 end) as d60
from catalog_sales, warehouse, ship_mode, call_center, date_dim
where cs_ship_date_sk = d_date_sk and d_year = 2001
  and cs_warehouse_sk = w_warehouse_sk
  and cs_ship_mode_sk = sm_ship_mode_sk
  and cs_call_center_sk = cc_call_center_sk
group by w_warehouse_name, sm_type, cc_name
order by w_warehouse_name, sm_type, cc_name limit 100
""",
}

SHAPES = {
    "q3_shape_brand_by_year": """
select d.d_year, i.i_brand_id, sum(ss.ss_ext_sales_price) as s from
store_sales ss join date_dim d on ss.ss_sold_date_sk = d.d_date_sk join item
i on ss.ss_item_sk = i.i_item_sk where i.i_manufact_id = 100 and d.d_moy =
11 group by d.d_year, i.i_brand_id order by d.d_year, s desc, i.i_brand_id
limit 20
""",
    "q7_shape_demographics_filter": """
select i.i_item_id, avg(ss.ss_quantity) as agg1, count(*) as n from
store_sales ss join customer_demographics cd on ss.ss_cdemo_sk =
cd.cd_demo_sk join promotion p on ss.ss_promo_sk = p.p_promo_sk join item i
on ss.ss_item_sk = i.i_item_sk where cd.cd_gender = 'M' and
cd.cd_marital_status = 'S' and p.p_channel_email = 'N' group by i.i_item_id
order by i.i_item_id limit 50
""",
    "q42_shape_category_by_year": """
select d.d_year, i.i_category_id, i.i_category, sum(ss.ss_ext_sales_price)
as s from store_sales ss join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
join item i on ss.ss_item_sk = i.i_item_sk where i.i_manufact_id < 200 and
d.d_moy = 12 and d.d_year = 2000 group by d.d_year, i.i_category_id,
i.i_category order by s desc, d.d_year, i.i_category_id, i.i_category limit
10
""",
    "cross_channel_union": """
select i.i_brand_id, sum(u.price) as s, count(*) as n from (select
ss_item_sk as item_sk, ss_ext_sales_price as price from store_sales union
all select cs_item_sk as item_sk, cs_ext_sales_price as price from
catalog_sales union all select ws_item_sk as item_sk, ws_ext_sales_price as
price from web_sales) u join item i on u.item_sk = i.i_item_sk where
i.i_manufact_id = 5 group by i.i_brand_id order by i.i_brand_id
""",
    "q22_shape_inventory_rollup": """
select i.i_product_name, avg(inv.inv_quantity_on_hand) as qoh from inventory
inv join date_dim d on inv.inv_date_sk = d.d_date_sk join item i on
inv.inv_item_sk = i.i_item_sk where d.d_year = 2000 group by
i.i_product_name order by qoh, i.i_product_name limit 25
""",
    "web_channel_site_rollup": """
select w.web_name, count(*) as n, sum(ws.ws_net_profit) as profit from
web_sales ws join web_site w on ws.ws_web_site_sk = w.web_site_sk join
date_dim d on ws.ws_sold_date_sk = d.d_date_sk where d.d_year = 2001 group
by w.web_name order by w.web_name
""",
}

ANALYTIC = {
    "ds_q98_window_ratio": """
select i_item_id, i_category, i_size, i_current_price,
sum(ss_ext_sales_price) as itemrevenue,
sum(ss_ext_sales_price)*100/sum(sum(ss_ext_sales_price)) over (partition by
i_size) as revenueratio from store_sales, item, date_dim where ss_item_sk =
i_item_sk and i_category in ('Sports','Books','Home') and ss_sold_date_sk =
d_date_sk and d_year = 1999 and d_moy between 2 and 3 group by i_item_id,
i_category, i_size, i_current_price order by i_category, i_size, i_item_id,
revenueratio limit 100
""",
    "ds_q89_window_avg": """
select * from ( select i_category, i_size, i_brand, s_store_name, d_moy,
sum(ss_sales_price) sum_sales, avg(sum(ss_sales_price)) over (partition by
i_category, i_brand, s_store_name) avg_monthly_sales from item, store_sales,
date_dim, store where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
and ss_store_sk = s_store_sk and d_year = 1999 group by i_category, i_size,
i_brand, s_store_name, d_moy) tmp1 where case when avg_monthly_sales <> 0
then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales else null end >
0.1 order by sum_sales - avg_monthly_sales, s_store_name limit 100
""",
    "ds_q47_rank_selfjoin": """
with v1 as ( select i_category, i_brand, s_store_name, d_year, d_moy,
sum(ss_sales_price) sum_sales, avg(sum(ss_sales_price)) over (partition by
i_category, i_brand, s_store_name, d_year) avg_monthly_sales, rank() over
(partition by i_category, i_brand, s_store_name order by d_year, d_moy) rn
from item, store_sales, date_dim, store where ss_item_sk = i_item_sk and
ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk and d_year = 1999
group by i_category, i_brand, s_store_name, d_year, d_moy), v2 as (select
v1.i_category, v1.i_brand, v1.s_store_name, v1.d_year, v1.d_moy,
v1.avg_monthly_sales, v1.sum_sales, v1_lag.sum_sales psum, v1_lead.sum_sales
nsum from v1, v1 v1_lag, v1 v1_lead where v1.i_category = v1_lag.i_category
and v1.i_category = v1_lead.i_category and v1.i_brand = v1_lag.i_brand and
v1.i_brand = v1_lead.i_brand and v1.s_store_name = v1_lag.s_store_name and
v1.s_store_name = v1_lead.s_store_name and v1.rn = v1_lag.rn + 1 and v1.rn =
v1_lead.rn - 1) select * from v2 where avg_monthly_sales > 0 and
abs(sum_sales - avg_monthly_sales) / avg_monthly_sales > 0.1 order by
sum_sales - avg_monthly_sales, s_store_name, i_brand, d_moy limit 100
""",
    "ds_q51_rows_running_sum": """
select item_sk, d_date, cume_sales from ( select ss_item_sk item_sk, d_date,
sum(sum(ss_sales_price)) over (partition by ss_item_sk order by d_date rows
between unbounded preceding and current row) cume_sales from store_sales,
date_dim where ss_sold_date_sk = d_date_sk and d_year = 2000 and ss_item_sk
< 200 group by ss_item_sk, d_date) x order by item_sk, d_date limit 100
""",
    "ds_lag_lead": """
select ss_item_sk, d_moy, s, lag(s, 1) over (partition by ss_item_sk order
by d_moy) p, lead(s) over (partition by ss_item_sk order by d_moy) nx from (
select ss_item_sk, d_moy, sum(ss_quantity) s from store_sales, date_dim
where ss_sold_date_sk = d_date_sk and d_year = 2000 and ss_item_sk < 50
group by ss_item_sk, d_moy) t order by ss_item_sk, d_moy
""",
    "ds_q44_global_rank": """
select * from (select ss_item_sk item_sk, avg(ss_net_profit) rank_col,
rank() over (order by avg(ss_net_profit) desc) rnk from store_sales where
ss_store_sk = 4 group by ss_item_sk) v where rnk < 11 order by rnk, item_sk
""",
    "ds_q86_rollup": """
select sum(ws_net_paid) as total_sum, i_category, i_size,
grouping(i_category)+grouping(i_size) as lochierarchy from web_sales,
date_dim d1, item where d1.d_year = 2000 and d1.d_date_sk = ws_sold_date_sk
and i_item_sk = ws_item_sk group by rollup(i_category, i_size) order by
lochierarchy desc, i_category, i_size limit 100
""",
    "ds_q86_rollup_rank": """
select total_sum, i_category, i_size, lochierarchy, rank() over (partition
by lochierarchy order by total_sum desc) as r from ( select sum(ws_net_paid)
as total_sum, i_category, i_size, grouping(i_category)+grouping(i_size) as
lochierarchy from web_sales, date_dim d1, item where d1.d_year = 2000 and
d1.d_date_sk = ws_sold_date_sk and i_item_sk = ws_item_sk group by
rollup(i_category, i_size)) t order by lochierarchy desc, r, i_category,
i_size limit 100
""",
    "ds_q38_intersect": """
select count(*) as n from ( select distinct i_brand, d_moy from store_sales,
date_dim, item where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
and d_year = 2000 intersect select distinct i_brand, d_moy from
catalog_sales, date_dim, item where cs_sold_date_sk = d_date_sk and
cs_item_sk = i_item_sk and d_year = 2000) hot
""",
    "ds_q87_except": """
select count(*) as n from ( select distinct i_brand, d_moy from store_sales,
date_dim, item where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
and d_year = 2000 except select distinct i_brand, d_moy from catalog_sales,
date_dim, item where cs_sold_date_sk = d_date_sk and cs_item_sk = i_item_sk
and d_year = 2000 and d_dom < 3) cool
""",
    "ds_union_distinct": """
select count(*) n from (select ss_item_sk k from store_sales union select
cs_item_sk k from catalog_sales) u
""",
    "ds_q28_cross_distinct": """
select * from (select avg(ss_list_price) b1_lp, count(ss_list_price) b1_cnt,
count(distinct ss_list_price) b1_cntd from store_sales where ss_quantity
between 0 and 5 and (ss_list_price between 8 and 18 or ss_wholesale_cost
between 57 and 77)) b1, (select avg(ss_list_price) b2_lp,
count(ss_list_price) b2_cnt, count(distinct ss_list_price) b2_cntd from
store_sales where ss_quantity between 6 and 10 and (ss_list_price between 90
and 100 or ss_wholesale_cost between 31 and 51)) b2, (select
avg(ss_list_price) b3_lp, count(ss_list_price) b3_cnt, count(distinct
ss_list_price) b3_cntd from store_sales where ss_quantity between 11 and 15
and (ss_list_price between 142 and 152 or ss_wholesale_cost between 79 and
99)) b3
""",
    "ds_nonequi_nljoin": """
select count(*) n from store s, item i where s.s_number_employees between
i.i_manufact_id and i.i_manufact_id + 1
""",
    "ds_q17_stddev": """
select i_item_id, s_state, count(ss_quantity) c1, avg(ss_quantity) a1,
stddev_samp(ss_quantity) s1, stddev_samp(sr_return_quantity) s2 from
store_sales, store_returns, item, store where ss_customer_sk =
sr_customer_sk and ss_item_sk = sr_item_sk and ss_ticket_number =
sr_ticket_number and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
group by i_item_id, s_state order by i_item_id, s_state limit 100
""",
    "ds_maxby_percentile": """
select i_category, max_by(i_item_id, ss_sales_price) top_item,
approx_percentile(ss_quantity, 0.5) med from store_sales, item where
ss_item_sk = i_item_sk group by i_category order by i_category
""",
    "ds_date_functions": """
select date_trunc('month', d_date) m, count(*) n, max(date_diff('day',
d_date, cast('2001-01-01' as date))) dd, min(day_of_week(d_date)) w from
date_dim where d_year = 2000 group by 1 order by 1
""",
    "ds_round_sqrt": """
select i_category, round(avg(ss_sales_price), 2) a, sqrt(sum(ss_quantity)) q
from store_sales, item where ss_item_sk = i_item_sk group by i_category
order by i_category
""",
}

QUERIES = {**ANSWERS, **SHAPES, **ANALYTIC}
