"""One module per query: `build(read, col, params)` returns the port's
DataFrame (`read(table)` is the source's DataFrame, `col` the port's column
constructor) and `COLUMNS` names its output columns in order."""
