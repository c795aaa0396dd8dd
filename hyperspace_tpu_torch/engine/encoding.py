"""Encoded execution at the lake boundary: dictionary-code string columns.

Counterpart of `hyperspace_tpu/engine/encoding.py`. A parquet column chunk
that is dictionary-encoded on disk is read with pyarrow's `read_dictionary`
and converted to a `Column` in code space (`dictionary_array_to_column`): O(N)
integer remaps plus one sort of the D distinct values, never N Python strings.
The result equals the flatten read's exactly (same sorted dictionary of the
present values, same codes, same validity). String columns are written back as
compacted arrow dictionary arrays (`dictionary_arrow_array`), so a bucket file
carries only the values it holds; the index writer's bytes depend on that.

`HYPERSPACE_ENCODED_EXEC=0` turns both off (reads flatten, writes decode), as
in the JAX package. The JAX package asks its planner when the flag is unset;
the planner is not ported, so unset means its default, on.
Dictionaries over `_ENCODED_DICT_MAX` entries take the flatten read (the JAX
package's default ceiling; the port reads no flag for it, since it changes
which read runs and never a result).

Accounting, as in the JAX package: each real decode ticks
`io.encoded.columns_encoded` or `io.encoded.columns_flattened` per
dictionary column, and the bytes that entered the engine still encoded
(codes, dictionary, validity) or flattened to values land on
`io.pruning.bytes_encoded_kept` / `io.pruning.bytes_materialized` and the
query's ledger.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import pyarrow as pa
import torch

from ..telemetry import accounting as _accounting
from ..telemetry import metrics as _metrics

ENV_ENCODED_EXEC = "HYPERSPACE_ENCODED_EXEC"
_ENCODED_DICT_MAX = 1 << 20


def encoded_exec_enabled() -> bool:
    """The flag when `HYPERSPACE_ENCODED_EXEC` is set ("0" off), else the
    planner's decision, else on."""
    raw = os.environ.get(ENV_ENCODED_EXEC, "")
    if raw != "":
        return raw != "0"
    from ..plananalysis.planner import decided_value

    decided = decided_value("encoded_exec")
    return True if decided is None else bool(decided)


COLUMNS_ENCODED = _metrics.counter("io.encoded.columns_encoded")
COLUMNS_FLATTENED = _metrics.counter("io.encoded.columns_flattened")
BYTES_ENCODED_KEPT = _metrics.counter("io.pruning.bytes_encoded_kept")
BYTES_MATERIALIZED = _metrics.counter("io.pruning.bytes_materialized")


def column_nbytes(c) -> int:
    """What one column holds: its tensors and its host dictionary (the one
    size the encoded-bytes counter and the scan cache's charge share)."""
    n = c.data.nbytes
    if c.validity is not None:
        n += c.validity.nbytes
    if c.dictionary is not None:
        n += c.dictionary.nbytes
    return int(n)


def record_encoded_kept(nbytes: int) -> None:
    BYTES_ENCODED_KEPT.inc(nbytes)
    _accounting.add("bytes_encoded_kept", nbytes)


def record_materialized(nbytes: int) -> None:
    BYTES_MATERIALIZED.inc(nbytes)
    _accounting.add("bytes_materialized", nbytes)


def _stringish_value_type(t: "pa.DataType") -> bool:
    return pa.types.is_string(t) or pa.types.is_large_string(t)


def dict_read_columns(meta, columns: Optional[List[str]]) -> List[str]:
    """The columns of a read to request as dictionaries from pyarrow: those
    whose every row-group chunk has a dictionary page and string values
    (`meta.dict_cols`, from `io.footer_metadata`). Empty when the flag is off
    or nothing qualifies."""
    if not encoded_exec_enabled() or meta is None or not meta.dict_cols:
        return []
    names = columns if columns is not None else meta.names
    return [c for c in names if meta.dict_cols.get(c)]


def _present_codes(valid_codes: np.ndarray, dict_len: int) -> np.ndarray:
    """Ascending distinct codes among `valid_codes`, by a presence mask over
    the D dictionary slots (O(N + D), no sort of the N codes)."""
    if not len(valid_codes):
        return np.empty(0, np.int64)
    seen = np.zeros(dict_len, bool)
    seen[valid_codes] = True
    return np.flatnonzero(seen)


def dictionary_array_to_column(arr):
    """Code-space conversion of one arrow dictionary column to a host
    `Column`, or None to take the flatten path (non-string values, or a
    dictionary over `_ENCODED_DICT_MAX`). Equal to the flatten path
    by construction: dictionary = sorted unique of the values PRESENT (plus
    the "" null fill when the column has nulls), codes = positions in it with
    null slots at 0, validity = the arrow null mask."""
    from .schema import STRING
    from .table import Column

    if isinstance(arr, pa.ChunkedArray):
        if not _stringish_value_type(arr.type.value_type):
            return None
        # Bail before the O(N) chunk unification: summed chunk dictionaries
        # bound the unified size from above.
        if sum(len(c.dictionary) for c in arr.chunks) > _ENCODED_DICT_MAX:
            return None
        arr = arr.combine_chunks()
    elif not _stringish_value_type(arr.type.value_type):
        return None
    if len(arr.dictionary) > _ENCODED_DICT_MAX:
        return None

    validity = None
    indices = arr.indices
    if arr.null_count > 0:
        validity = ~np.asarray(arr.is_null().to_numpy(zero_copy_only=False))
        indices = indices.fill_null(0)
    codes = np.asarray(indices)
    dvals = arr.dictionary.to_numpy(zero_copy_only=False)
    dvals = np.empty(0, dtype="<U1") if len(dvals) == 0 else np.asarray([str(x) for x in dvals])
    # Present values come from valid slots only; the flatten path uniques the
    # "" null fill, appended below, not what a null slot's index points at.
    valid_codes = codes if validity is None else codes[validity]
    present = _present_codes(valid_codes, len(dvals))
    vals = dvals[present]
    if validity is not None:
        vals = np.concatenate([vals, np.asarray([""], dtype=vals.dtype)])
    sorted_dict, inv = np.unique(vals, return_inverse=True)
    remap = np.zeros(max(len(dvals), 1), np.int32)
    remap[present] = inv.reshape(-1)[: len(present)].astype(np.int32)
    new_codes = remap[codes].astype(np.int32, copy=False)
    if validity is not None:
        new_codes[~validity] = 0  # canonical null fill (as from_values)
    valid_t = None if validity is None else torch.from_numpy(validity)
    return Column(STRING, torch.from_numpy(new_codes), sorted_dict, valid_t, encoded_read=True)


def dictionary_arrow_array(
    codes: np.ndarray, dictionary: np.ndarray, mask: Optional[np.ndarray]
) -> "pa.DictionaryArray":
    """Compacted arrow dictionary array of one string column slice: only the
    values present among its valid slots, null slots at index 0 (so the bytes
    written do not depend on the codes under the mask)."""
    valid_codes = codes if mask is None else codes[~mask]
    present = _present_codes(valid_codes, len(dictionary))
    sub = dictionary[present]  # an ascending subset of a sorted dictionary stays sorted
    remap = np.zeros(max(len(dictionary), 1), np.int32)
    remap[present] = np.arange(len(present), dtype=np.int32)
    new_codes = remap[codes]
    if mask is not None:
        new_codes[mask] = 0
    return pa.DictionaryArray.from_arrays(pa.array(new_codes, mask=mask), pa.array(sub))
