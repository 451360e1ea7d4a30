"""The refine's candidate set, stable sort and gathers, ms a refine: the entry `refine/compact` summed over the window's
steps that hold it, over their number."""


def read(run):
    ms = [s["refine/compact"] for s in run.get("steps") or [] if "refine/compact" in s]
    return sum(ms) / len(ms) if ms else None
