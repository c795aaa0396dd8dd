"""The columnar query engine of the port: tables of torch tensors on the
session's device, a logical/physical plan pair, and the DataFrame API."""
