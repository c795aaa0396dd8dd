"""serve layer (`serve/scheduler.py`): the 95th percentile of the server's
queue wait over the window, from its `serve.queue.wait_s` histogram (reset
as the window opens), in ms."""


def read(run):
    v = run.after.get("queue_wait_p95_s")
    return None if v is None else 1e3 * v
