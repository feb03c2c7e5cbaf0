"""The fleet tier's shared primitives, so far ``lease`` (SIGKILL-safe
flock leases; the journal compactor's lock) and ``client`` (the stdlib
HTTP JSON client ``submit`` speaks through). The router, workers and
placement are not ported yet (ROADMAP.md Queue 1 item 8)."""
