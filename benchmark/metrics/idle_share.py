"""Idle share of the card over the traced window, in percent: 1 - (time
inside device operations / the span from the first one's start to the
last one's end)."""

from benchmark import trace


def read(run):
    share = trace.idle_share(run.ops)
    return None if share is None else 100 * share
