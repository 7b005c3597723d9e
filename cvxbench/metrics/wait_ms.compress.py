"""wait_ms.compress (ms, program span): host time a traced compress call
spends waiting on the card, in the program's `cvx.*_wait` spans (the
RMS's read-back, the sizes' and the stream's copies)."""

from cvxbench.harness import waits


def read(run):
    return waits.waits_ms(run, "compress")
