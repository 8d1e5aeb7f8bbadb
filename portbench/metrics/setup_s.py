"""setup_s: process start to the first timed dispatch (host clock):
CUDA start, the kernel libraries' build or load, interning, the id rows'
upload, the populate launches and the warm-up."""


def read(run):
    return run.setup_s
