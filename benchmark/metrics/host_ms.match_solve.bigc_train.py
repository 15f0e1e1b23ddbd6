"""Host ms a BIG-C train step inside its ``match.solve`` span (the Hungarian
assignment on the host, scipy, video by video), from the program-span
pass."""
from benchmark.harness.program_pass import host_ms


def read(run):
    return host_ms(run, "match.solve", ["bigc.train"])
