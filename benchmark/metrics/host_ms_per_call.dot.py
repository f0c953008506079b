"""Host milliseconds per dot request over the window: the host clock from
the request's start to just before its synchronise, averaged."""


def read(run):
    host = run.window.host_s
    return 1e3 * sum(host) / len(host) if host else None
