"""setup_s (s, host clock): process start to the first timed call: imports,
the kernel library, the snapshot buffers and one warm round."""


def read(run):
    return run.setup_s
