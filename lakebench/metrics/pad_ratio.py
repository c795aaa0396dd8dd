"""Join layout (`ops/bucket_join.py`): bytes the joins' bucket pads took per
byte of payload over the window (`pad.bytes_padded` / `pad.bytes_payload`)."""


def read(run):
    payload = run.counter_delta("pad.bytes_payload")
    return run.counter_delta("pad.bytes_padded") / payload if payload else None
