"""Device: the share of the traced stretch in which no kernel, copy or memset
ran on the card (1 - the union of their intervals over the stretch's
length), in percent."""

from lakebench import devtrace


def read(run):
    if run.stretch is None or run.stretch.seconds <= 0:
        return None
    return 100.0 * (1.0 - devtrace.busy_seconds(run.stretch) / run.stretch.seconds)
