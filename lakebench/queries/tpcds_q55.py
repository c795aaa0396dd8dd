"""TPC-DS Q55: store_sales of manager MANAGER's items in month MONTH of year
YEAR, summed by brand; ORDER BY the sum descending, the brand id; LIMIT 100.
The fact joins item first, as in `tpcds_q3`."""

COLUMNS = ["i_brand_id", "i_brand", "ext_price"]


def build(read, col, p):
    item = read("item").filter(col("i_manager_id") == p["MANAGER"])
    dd = read("date_dim").filter((col("d_moy") == p["MONTH"]) & (col("d_year") == p["YEAR"]))
    return (
        read("store_sales").join(item, col("ss_item_sk") == col("i_item_sk"))
        .join(dd, col("ss_sold_date_sk") == col("d_date_sk"))
        .group_by("i_brand_id", "i_brand").agg(ext_price=("ss_ext_sales_price", "sum"))
        .order_by(("ext_price", False), "i_brand_id")
        .limit(100)
        .select(*COLUMNS)
    )
