"""The device's idle share over the traced frames, %: 1 - busy / window."""

from benchmark.harness import idle_share


def read(run):
    return idle_share(run)
