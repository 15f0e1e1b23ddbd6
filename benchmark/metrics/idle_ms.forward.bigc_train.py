"""Device idle ms a BIG-C train step inside its ``forward`` span (the model
call: encoder, decoder, head), from the program-span pass."""
from benchmark.harness.program_pass import idle_ms


def read(run):
    return idle_ms(run, "forward", ["bigc.train"])
