"""The fleet tier's shared primitives, so far ``lease`` (SIGKILL-safe
flock leases; the journal compactor's lock). The router, workers and
placement are not ported yet (ROADMAP.md Queue 1 item 8)."""
