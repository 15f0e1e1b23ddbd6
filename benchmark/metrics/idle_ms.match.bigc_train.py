"""Device idle ms a BIG-C train step inside its ``match`` span (the matching
cost, its copy to the host, the Hungarian solve and the upload), from the
program-span pass."""
from benchmark.harness.program_pass import idle_ms


def read(run):
    return idle_ms(run, "match", ["bigc.train"])
