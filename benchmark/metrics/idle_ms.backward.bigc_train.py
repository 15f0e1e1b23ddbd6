"""Device idle ms a BIG-C train step inside its ``backward`` span (autograd),
from the program-span pass."""
from benchmark.harness.program_pass import idle_ms


def read(run):
    return idle_ms(run, "backward", ["bigc.train"])
