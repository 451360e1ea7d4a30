"""The share of the viewer's record pool that holds a record, %: 100 times
the counters `#records` over `#pool_slots`, summed over the window's
frames (100 where the pool overflows: `#records` is clamped to it)."""


def read(run):
    steps = run.get("steps") or []
    slots = sum(s.get("#pool_slots", 0) for s in steps)
    if not slots:
        return None
    return 100.0 * sum(s.get("#records", 0) for s in steps) / slots
