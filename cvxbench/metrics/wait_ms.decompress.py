"""wait_ms.decompress (ms, program span): host time a traced decompress
call spends on the plan's upload and any wait on the card: the program's
`cvx.plan_h2d` (the pageable copy of the plan, which holds the host for
its whole length, the host's own staging of it included) and any
`cvx.*_wait` span."""

from cvxbench.harness import waits


def read(run):
    return waits.waits_ms(run, "decompress", also=("cvx.plan_h2d",))
