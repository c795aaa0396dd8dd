"""The plain references: numpy over the generated arrays, one module per
query. Each states what `judge.compare` reads (`COLUMNS`, `LIMIT`, `ORDER`,
`IDENT`, `EXACT`, `MEASURES`), the precision its measures are summed in
(`DTYPE`) and the control's (`CONTROL_DTYPE`, the nearest below), and gives
`prepare(tables, space, shared)` (work shared by every parameter in the
mix's `space`; `shared` is one dict a run gives every reference), `answer(state, params, dtype)` (every group in the query's order)
and `join_rows(state, params)` (the rows each side of the query's joins
takes, for the kernels' work). Nothing here reads a file or a tensor the
program wrote, nor imports the program."""
