"""setup_build_s: host seconds of the program's model build before the
window (the setup.build_models span, training/builder.build_models): the
models made and their weights drawn on the device, the first CUDA touch
included. Moves setup_s."""
from benchmark import program_spans

UNIT = "s"


def read(run):
    return program_spans.setup_s(run, ("setup.build_models",))
