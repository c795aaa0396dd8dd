"""Narrow dictionary codes on the device (counterpart of `hyperspace_tpu/engine/encoded_device.py`).

The JAX package uploads a qualifying string column's codes as int8 (at most
127 entries) or int16 (at most 32767) instead of int32, and a sub-byte one as
packed words that the device unpacks back to the same int8 lane, to upload
fewer bytes. In the port the codes already live on the session's device as
int32, so narrowing saves nothing: no engine path stages narrow codes, and
`bucketize_table` hashes and sorts the int32 codes themselves. `stage_codes`
stays as the JAX package's ops API (a narrow code tensor on the column's
device, no upload cache), equal to the JAX lane value for value. The gates
below reach the engine only through `packed_codes_enabled`, whose auto mode
rides `encoded_device_enabled`.

`HYPERSPACE_ENCODED_DEVICE`: unset = auto (on when `HYPERSPACE_ENCODED_EXEC`
is on; a column must also have ridden an encoded read), `0` = off, anything
else = on for every narrowable string column.
"""

from __future__ import annotations

import os

import torch

ENV_ENCODED_DEVICE = "HYPERSPACE_ENCODED_DEVICE"

_INT8_MAX_CARD = 127
_INT16_MAX_CARD = 32767


def encoded_device_mode() -> str:
    """"off" | "force" | "auto" (the unset default)."""
    raw = os.environ.get(ENV_ENCODED_DEVICE, "")
    if raw == "":
        return "auto"
    return "off" if raw == "0" else "force"


def encoded_device_enabled() -> bool:
    mode = encoded_device_mode()
    if mode != "auto":
        return mode == "force"
    from .encoding import encoded_exec_enabled

    return encoded_exec_enabled()


def code_dtype_for(cardinality: int):
    """Smallest signed dtype holding codes [-1, cardinality); None = int32
    is already the narrowest."""
    if cardinality <= _INT8_MAX_CARD:
        return torch.int8
    if cardinality <= _INT16_MAX_CARD:
        return torch.int16
    return None


def narrowable(col) -> bool:
    """May this column's codes travel narrow?"""
    if not encoded_device_enabled() or not col.is_string:
        return False
    return code_dtype_for(len(col.dictionary)) is not None


def column_qualifies(col) -> bool:
    """`narrowable`, plus in auto mode a column that rode an encoded read."""
    if not narrowable(col):
        return False
    return encoded_device_mode() == "force" or col.encoded_read


def narrow_codes(col) -> torch.Tensor:
    """The column's codes in the narrowest dtype that holds them."""
    dt = code_dtype_for(len(col.dictionary))
    if dt is None or col.data.dtype != torch.int32:
        return col.data
    return col.data.to(dt)


def stage_codes(col) -> torch.Tensor:
    """A key lane of `col` on its device: narrow codes for a qualifying string
    column, its data otherwise. (The JAX package's packed tier unpacks to this
    same narrow lane, so it needs no separate path here.)"""
    if not column_qualifies(col):
        return col.data
    return narrow_codes(col)
