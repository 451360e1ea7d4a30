"""SplatTrainer._refine (the pre-grow, the refine function, the grow
or shrink), ms a refine: the entry `refine` summed over the window's
steps that hold it, over their number."""


def read(run):
    ms = [s["refine"] for s in run.get("steps") or [] if "refine" in s]
    return sum(ms) / len(ms) if ms else None
