"""Device idle ms a grounding train step inside its ``optim`` span (the
global-norm clip and Adam), from the program-span pass."""
from benchmark.harness.program_pass import idle_ms


def read(run):
    return idle_ms(run, "optim", ["grounding.train"])
