"""Host clock to a device barrier around the program's device build in set-up."""


def read(run):
    return run.index_build_s
