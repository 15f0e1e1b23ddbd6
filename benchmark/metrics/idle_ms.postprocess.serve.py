"""Device idle ms a request inside its ``postprocess`` span (BIG-C's triplet
construction, the grounding decode), from the program-span pass."""
from benchmark.harness.program_pass import idle_ms


def read(run):
    return idle_ms(run, "postprocess", ["bigc.infer", "grounding.infer"])
