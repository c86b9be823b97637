"""tune_s: host seconds of set-up's search of every shape key (builds
served from the cache after a checkout's first run)."""


def read(r):
    return r.counters.get("tune_s")
