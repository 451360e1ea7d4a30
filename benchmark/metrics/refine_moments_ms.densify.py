"""The refine's Adam state surgery, ms a refine: the entry `refine/moments` summed over the window's
steps that hold it, over their number."""


def read(run):
    ms = [s["refine/moments"] for s in run.get("steps") or [] if "refine/moments" in s]
    return sum(ms) / len(ms) if ms else None
