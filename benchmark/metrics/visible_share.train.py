"""The share of the rows the per-row stages ran over that were visible, %: 100
times the counters `#visible` over `#rows`, summed over the window's steps."""


def read(run):
    steps = run.get("steps") or []
    rows = sum(s.get("#rows", 0) for s in steps)
    if not rows:
        return None
    return 100.0 * sum(s.get("#visible", 0) for s in steps) / rows
