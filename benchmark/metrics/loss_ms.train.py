"""ssim and the loss, forward and backward (marks `loss`, `loss backward`), ms
a step."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["loss", "loss backward"])
