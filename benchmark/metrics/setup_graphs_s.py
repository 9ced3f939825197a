"""setup_graphs_s: host seconds of the program's CUDA graphs' warm-ups
and captures before the window (Σ graph.warmup + graph.capture spans,
utils/graphs.Graphed): each graphed shape's eager first call and its
capture. Moves setup_s."""
from benchmark import program_spans

UNIT = "s"


def read(run):
    return program_spans.setup_s(run, ("graph.warmup", "graph.capture"))
