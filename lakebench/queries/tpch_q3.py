"""TPC-H Q3 (shipping priority, clause 2.4.3): lineitem shipped after DATE
joined to orders placed before it and to the SEGMENT's customers, revenue
summed per order, the 10 largest by revenue, then order date."""

COLUMNS = ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]


def build(read, col, p):
    li = read("lineitem").filter(col("l_shipdate") > p["DATE"])
    od = read("orders").filter(col("o_orderdate") < p["DATE"])
    cu = read("customer").filter(col("c_mktsegment") == p["SEGMENT"])
    return (
        li.join(od, col("l_orderkey") == col("o_orderkey"))
        .join(cu, col("o_custkey") == col("c_custkey"))
        .with_column("revenue", col("l_extendedprice") * (1 - col("l_discount")))
        .group_by("l_orderkey", "o_orderdate", "o_shippriority")
        .agg(revenue=("revenue", "sum"))
        .order_by(("revenue", False), "o_orderdate")
        .limit(10)
        .select(*COLUMNS)
    )
