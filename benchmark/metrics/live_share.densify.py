"""The share of the rows the per-row stages ran over that were live, %: 100
times the counters `#live` over `#capacity`, summed over the window's
steps."""


def read(run):
    steps = run.get("steps") or []
    rows = sum(s.get("#capacity", 0) for s in steps)
    if not rows:
        return None
    return 100.0 * sum(s.get("#live", 0) for s in steps) / rows
