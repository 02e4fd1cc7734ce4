"""setup_s (s, host clock): from the process's start to the window's:
imports, the kernel libraries (built by nvcc on a checkout's first run),
the instance, the relabelings and one warm solve."""


def read(run):
    return run.setup_s
