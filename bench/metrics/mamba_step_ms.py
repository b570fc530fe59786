"""The program's ``mamba.step`` spans (one Mamba layer's decode step,
host time, no synchronisation) summed over each decode step
(``model.step``), mean a step, in ms; over the requests outside the
profiled stretch. None where the program records no such span."""


def read(run):
    prog = run.program
    if prog is None:
        return None
    steps = mamba = 0
    total = 0.0
    for s in prog.spans:
        if s.req not in run.span_reqs:
            continue
        if s.name == "model.step":
            steps += 1
        elif s.name == "mamba.step":
            mamba += 1
            total += s.dur_s
    if not steps or not mamba:
        return None
    return 1e3 * total / steps
