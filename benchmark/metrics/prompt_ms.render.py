"""prompt_ms.render: ms per view of the benchmark's span around
PromptManager.embed_prompts, ended at a synchronize in the traced run.
Moves render_imgs_per_s."""
from benchmark import readers

UNIT = "ms"
SPAN = "bench.prompt"


def read(run):
    return readers.span_ms(run, SPAN)
