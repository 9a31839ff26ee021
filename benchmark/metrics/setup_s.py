"""setup_s: from the start of the harness's script to the first timed
call: imports, CUDA initialisation, the kernel library (built into the
checkout's build/ on the first run), genome, index build, traffic pool
and warm-up."""


def read(run):
    return run.setup_s
