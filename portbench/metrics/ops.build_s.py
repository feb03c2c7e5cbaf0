"""ops.build_s (s): the program's ``engine.compile`` span around building
the runner: the kernels' build (first run of a checkout) or load, and the
tuner's plan consult."""


def read(r):
    spans = [s["duration_s"] for s in r.spans if s["name"] == "engine.compile"]
    return sum(spans) if spans else None
