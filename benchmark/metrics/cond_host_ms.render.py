"""cond_host_ms.render: host ms a view of the program's own span around
PromptManager.embed_prompts (prompt.embed, utils/profiling.span), which
ends with no synchronize: the mean over the spans that start in the
traced window. Beside prompt_ms.render (the benchmark's span, ended at a
synchronize): equal when the host paces the conditioning, far lower when
the card does. Moves render_imgs_per_s."""
from benchmark import program_spans

UNIT = "ms"
SPAN = "prompt.embed"


def read(run):
    spans = program_spans.in_window(run, SPAN)
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / len(spans) / 1e3
