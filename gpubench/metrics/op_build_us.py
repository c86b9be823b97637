"""op_build_us: host microseconds an op call spends in the port's
``build.load`` (the source's hash, the library's exists-check and the
loaded-library lookup), summed over the recorded segment's calls
(``op.*`` spans) and divided by their number."""


def read(r):
    calls = sum(len(v) for k, v in r.spans.items() if k.startswith("op."))
    loads = r.spans.get("build.load")
    if not calls or not loads:
        return None
    return sum(loads) / calls * 1e6
