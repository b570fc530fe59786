"""The program's ``state_h2d_bytes`` (the Mamba layers' ``ssm`` and
``conv`` bytes that the lane copy moves to the device) over the window's
served requests, in MB a request. None where the program counts no
such bytes."""


def read(run):
    prog = run.program
    served = sum(1 for r in run.records if r["ok"])
    if prog is None or not served or "state_h2d_bytes" not in prog.counters:
        return None
    return prog.counters["state_h2d_bytes"] / served / 1e6
