"""TPC-DS Q3: store_sales of the items of manufacturer MANUFACT in month
MONTH of every year, summed by year and brand; ORDER BY d_year, the sum
descending, the brand id; LIMIT 100. The fact joins item first, so that its
covering index on ss_item_sk and item's index make a co-bucketed pair."""

COLUMNS = ["d_year", "i_brand_id", "i_brand", "sum_agg"]


def build(read, col, p):
    item = read("item").filter(col("i_manufact_id") == p["MANUFACT"])
    dd = read("date_dim").filter(col("d_moy") == p["MONTH"])
    return (
        read("store_sales").join(item, col("ss_item_sk") == col("i_item_sk"))
        .join(dd, col("ss_sold_date_sk") == col("d_date_sk"))
        .group_by("d_year", "i_brand_id", "i_brand").agg(sum_agg=("ss_ext_sales_price", "sum"))
        .order_by("d_year", ("sum_agg", False), "i_brand_id")
        .limit(100)
        .select(*COLUMNS)
    )
