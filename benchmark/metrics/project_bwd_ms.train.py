"""The projection's backward (project_splats, normalize_quats), ms a step: the
grad span `backward/project`."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["backward/project"])
