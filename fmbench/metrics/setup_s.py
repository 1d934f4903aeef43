"""Process start to the first timed batch: data, device build, LUT, warm-up."""


def read(run):
    return run.setup_s
