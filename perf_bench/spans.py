"""What the readers of the port's own spans and counters share.

The port keeps them in an in-memory store of the process that ran the cell
(`balance_robot_tpu_torch.utils.profiling`: `spans()`, `counters()`); a
reader reads it in-process, after the window. This module and the readers
that use it are the one place outside `program.py`, the drivers and
`faults.py` where the benchmark touches the port. A stored span is (name,
parent index, start_ns, end_ns), on `time.perf_counter_ns()`, the clock of
the harness's window; `end_ns` is None for a per-step span that the
profiler did not record whole (the step in which the traced span ends; the
step in which it starts is not stored at all). A program with no store
reads as nothing: the reader returns None.
"""


def store():
    """(spans, counters) of the port's store, or None where the port keeps
    none."""
    from balance_robot_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans"):
        return None
    return profiling.spans(), profiling.counters()


def read(value):
    """value(spans, counters) on the port's store, or None."""
    found = store()
    return None if found is None else value(*found)


def cli_steps(spans):
    """Over the complete `cli.step` spans (`cli._run_episodes`, one per
    step of the B = 1 loop): {steps, step_ns (their summed length), wait_ns
    and syncs (the summed length and the number of the complete `cli.sync.*`
    spans inside them, at any depth)}, or None where there is no complete
    step."""
    owner = []          # the enclosing cli.step of each span, or None
    for name, parent, _, _ in spans:
        owner.append(len(owner) if name == "cli.step"
                     else None if parent is None else owner[parent])
    steps = {i for i, s in enumerate(spans)
             if s[0] == "cli.step" and s[3] is not None}
    if not steps:
        return None
    syncs = [s for i, s in enumerate(spans)
             if s[0].startswith("cli.sync.") and s[3] is not None
             and owner[i] in steps]
    return dict(steps=len(steps),
                step_ns=sum(spans[i][3] - spans[i][2] for i in steps),
                wait_ns=sum(e - b for _, _, b, e in syncs),
                syncs=len(syncs))


def seconds(spans, names):
    """The summed length (s) of the complete spans whose name is one of
    `names`, or None where there is none."""
    found = [e - b for n, _, b, e in spans if n in names and e is not None]
    return 1e-9 * sum(found) if found else None
