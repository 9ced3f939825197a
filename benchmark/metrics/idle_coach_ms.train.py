"""idle_coach_ms.train: device-idle ms an optimizer step in the traced
window's gaps that begin while the program's coach.loop span is open but
no coach.step span is: the Coach's feed, stage, log, save or its window's
own code, not the step's launch. Moves train_imgs_per_s."""
from benchmark import program_spans

UNIT = "ms"


def read(run):
    return program_spans.idle_ms_per_unit(
        run, program_spans.mapped(run, ("coach.loop",)),
        program_spans.mapped(run, ("coach.step",)))
